"""How much of B4's `wgmma` fold the two consumer warpgroups hide.

    python3 -m recbox_tpu_torch.tools.fold_share   # repository root, one card

B4's packed segment-candidate kernel (`csrc/mips_topk.cu`, its `wgmma`
route; B3's stage (a)) at B3's serving plan (1M rows, Q=8192, 8 segments a
sub-chunk; N(0, 1) data), bf16 and int8, D = 64 and 128, is timed whole and
in three measurement builds, in turns on the same inputs. Each build is a
copy of the source under `build/fold_share/` with probe lines spliced in
(`_PATCHES`; a splice whose anchor is gone fails the run), compiled with
`-DWGMMA_PROBE=`:

  1 products only: each tile's first accumulator is summed into a value
    stored under a condition that never holds (with no use of the
    accumulators ptxas drops the products as dead code);
  2 fold only: no products; each tile moves every accumulator by an amount
    ptxas cannot know (0 at run time), so the fold plus one add an
    accumulator;
  3 neither: the ring, the barriers and the stores.

Each part's cost is its build's time less the pipeline's (3): hidden =
products + fold - whole, as a share of the fold, an upper bound since the
fold-only build does one add more. The products-only time must not beat the
operations bound, and its HGMMA / IGMMA count (`cuobjdump`) must equal the
whole kernel's: both show the build kept its products. One JSON line per
(dtype, depth) after the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

# (anchor in `csrc/mips_topk.cu`, what replaces it), each anchor found once
_PATCHES = (
    ("    for (int i = 0; i < 64; ++i) d[i] = 0;\n",
     "    for (int i = 0; i < 64; ++i) d[i] = 0;\n"
     "    [[maybe_unused]] float keep = 0.f;\n"
     "    [[maybe_unused]] const Acc bump = (Acc)(valid < 0);\n"
     "    if constexpr (WGMMA_PROBE == 2) {\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 64; ++i) d[i] = (Acc)(t * 64 + i);\n"
     "    }\n"),
    ("          mma_slice(d, adesc + ka, qdesc + kq, kk > 0);\n",
     "          if constexpr (WGMMA_PROBE < 2)\n"
     "            mma_slice(d, adesc + ka, qdesc + kq, kk > 0);\n"),
    ("        wgmma_commit();\n"
     "        wgmma_wait<0>();\n"
     "        fence_regs(d);\n"
     "        __syncwarp();\n"
     "        if (lane == 0) mbar_arrive(&empty[s]);\n",
     "        if constexpr (WGMMA_PROBE == 2) {\n"
     "#pragma unroll\n"
     "          for (int i = 0; i < 64; ++i) d[i] += bump;\n"
     "        }\n"
     "        wgmma_commit();\n"
     "        wgmma_wait<0>();\n"
     "        fence_regs(d);\n"
     "        __syncwarp();\n"
     "        if (lane == 0) mbar_arrive(&empty[s]);\n"
     "        if constexpr (WGMMA_PROBE == 1) keep += (float)d[0];\n"
     "        if constexpr (WGMMA_PROBE == 1 || WGMMA_PROBE == 3) continue;\n"),
    ("      named_sync(wg, WG);\n    }\n  }\n}\n",
     "      named_sync(wg, WG);\n    }\n"
     "    if constexpr (WGMMA_PROBE == 1) {\n"
     "      if (nq < 0) cand_s[t] = keep;  // never: keeps the products\n"
     "    }\n  }\n}\n"),
)

PROBES = {1: "products_only", 2: "fold_only", 3: "pipeline_only"}


def patched_source(text: str) -> str:
    """``text`` (B4's source) with the probe lines spliced in."""
    for anchor, repl in _PATCHES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"fold_share: anchor found {text.count(anchor)}"
                               f" times in mips_topk.cu:\n{anchor}")
        text = text.replace(anchor, repl)
    return "#ifndef WGMMA_PROBE\n#define WGMMA_PROBE 0\n#endif\n" + text


def build_probes() -> dict:
    """Compile the three measurement builds together; {probe: library}."""
    from recbox_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR.parent / "fold_share"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mips_topk_probe.cu"
    src.write_text(patched_source(
        (_build.CSRC / _build.SOURCES["mips_topk"]).read_text()))
    procs = {}
    for probe in PROBES:
        lib = out_dir / f"libmips_topk_probe{probe}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               f"-DWGMMA_PROBE={probe}", "-o", str(lib), str(src)]
        procs[probe] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        lib)
    for probe, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"fold_share: probe {probe} build failed\n{log}")
    return {probe: lib for probe, (_, lib) in procs.items()}


def tensor_core_instructions(lib: Path) -> dict:
    """HGMMA / IGMMA instructions in the SASS of library ``lib``'s packed
    n_seg = 8 `wgmma` instantiations, keyed by their template arguments."""
    from recbox_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        fname, body = part.split("\n", 1)
        m = re.search(r"segment_candidates_wgmmaI(\w+?Lb1ELi8ELi\d+)E", fname)
        if m:
            out[m.group(1)] = len(re.findall(r"\b[HI]GMMA\b", body))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fold_share: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs
    from recbox_tpu_torch.ops import _build
    from recbox_tpu_torch.ops import mips_topk as m
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = {"whole": _build._library("mips_topk")}
    _build.load("mips_topk")
    libs.update({PROBES[p]: lib for p, lib in build_probes().items()})
    entry = m._kernel_lib().recbox_mips_segment_candidates_wgmma
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).recbox_mips_segment_candidates_wgmma
        fn.argtypes, fn.restype = entry.argtypes, entry.restype
        fns[name] = fn
    gmma = {name: tensor_core_instructions(lib) for name, lib in libs.items()}
    assert gmma["products_only"] == gmma["whole"], gmma
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    n, nq = cs.N_ITEMS, cs.N_QUERIES
    for variant in ("bf16", "int8"):
        for d in (cs.DIM, 128):
            key = ("13__nv_bfloat16" if variant == "bf16" else "a") + \
                f"Lb1ELi8ELi{d}"
            q, c, scale = cs.make_inputs(variant, n, d, nq, gen)
            q = m.quantize_int8(q)[0] if variant == "int8" \
                else q.to(torch.bfloat16)
            win = torch.empty((-(-n // 1024) * 8, nq), device="cuda")

            def call(fn):
                rc = fn(m._DTYPES[c.dtype], 1, q.data_ptr(), c.data_ptr(),
                        None if scale is None else scale.data_ptr(),
                        win.data_ptr(), None, nq, n, d, n, 1024,
                        torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            times = {name: [] for name in fns}
            for name in (*fns, *reversed(fns)):
                times[name].append(cs.cuda_ms(lambda: call(fns[name])))
            whole, prod, fold, pipe = (statistics.median(times[name]) for name
                                       in ("whole", "products_only",
                                           "fold_only", "pipeline_only"))
            hidden = (prod - pipe) + (fold - pipe) - (whole - pipe)
            ops_ms = 2.0 * nq * n * d / cs.PEAK_OPS[variant] * 1e3
            assert prod >= ops_ms, (variant, d, prod, ops_ms)
            print(json.dumps({
                "variant": variant, "d": d, "whole_ms": whole,
                "tensor_core_instructions": {name: gmma[name][key]
                                             for name in fns},
                "products_only_ms": prod, "fold_only_ms": fold,
                "pipeline_only_ms": pipe,
                "products_over_ops_bound": prod / ops_ms,
                "fold_hidden_ms": hidden,
                "fold_hidden_share": hidden / (fold - pipe),
                "fold_exposed_share_of_whole": (whole - prod) / whole}),
                flush=True)
            del q, c, scale, win
    return 0


if __name__ == "__main__":
    sys.exit(main())
