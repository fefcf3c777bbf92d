"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository root, on a machine with the cell's CUDA devices. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, also the last lines of standard error.
Without the devices, or if JAX or the JAX package was loaded, it prints no
result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "recbox_tpu")
PYCACHE = ("build", "pycache")


def cache_bytecode() -> None:
    """Keep the bytecode of what a run imports (torch, the port, the
    harness) in the checkout's ``build/pycache``, at a fixed path: where the
    environment sets PYTHONDONTWRITEBYTECODE, every process otherwise
    compiles torch's modules from source again, 7-12 s of set-up that
    swings with the host's load. The first run of a checkout writes it."""
    from pathlib import Path
    sys.dont_write_bytecode = False
    if sys.pycache_prefix is None:
        sys.pycache_prefix = str(Path(__file__).resolve().parents[1].joinpath(
            *PYCACHE))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``recbox_tpu_torch`` is the port, not the package)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def port_counters() -> Dict[str, int]:
    """The port's kernel launch counters, flattened."""
    from recbox_tpu_torch.ops import (
        bitonic_topk, mips_fused_topk, mips_topk, packed_delta,
    )
    out = {}
    for mod, names in ((bitonic_topk, ("launches", "stream_launches",
                                       "large_launches")),
                       (mips_fused_topk, ("launches", "stream_launches",
                                          "large_launches")),
                       (mips_topk, ("launches", "route_launches")),
                       (packed_delta, ("launches",))):
        short = mod.__name__.rsplit(".", 1)[1]
        for name in names:
            for key, n in getattr(mod, name).items():
                out[f"{short}.{name}.{key}"] = n
    return out


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config: Optional[dict] = None,
             traffic: Optional[dict] = None, control: bool = False,
             t0: float = T0) -> SimpleNamespace:
    """Set up, time and check one cell; ``config`` / ``traffic`` replace
    the cell's files (the tests run cells at a small size on the CPU)."""
    import torch

    from benchmark import trace as tr
    from benchmark.spec import load_module

    cell = spec.cell(name)
    cfg = config or spec.config(cell)
    mix = traffic or spec.traffic(cell)
    system = load_module(spec.system_path(cfg))
    ref = load_module(spec.reference_path(cfg))
    cuda = torch.device(device).type == "cuda"
    imports = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()  # makes the CUDA context
    start = time.perf_counter() - t0
    st = system.setup(cfg, mix, seed, device, ref, control=control)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = port_counters()
    if trace:
        win, trc = tr.device_window(lambda: system.window(st, seconds))
    else:
        win, trc = system.window(st, seconds), None
    after = port_counters()
    diff = {k: after[k] - before.get(k, 0) for k in after}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    phases = (f"start {start:.3f} s (imports {imports:.3f} s, CUDA context "
              f"{start - imports:.3f} s), {st.phases}")
    out = SimpleNamespace(cell=cell, config=cfg, traffic=mix, setup_s=setup_s,
                          window=win, trace=trc, memory_peak_bytes=peak,
                          phases=phases,
                          routes=system.routes(diff, win, mix["route"]))
    out.end_to_end = {**system.end_to_end(st, win), "setup_s": setup_s}
    ctx = SimpleNamespace(trace=trc, counters=diff, traffic=mix,
                          window_s=trc.window_s if trc else win["window_s"],
                          **system.layer_context(st, win))
    out.per_layer = {}
    for metric in spec.per_layer_of(cell):
        reader = load_module(spec.metric_path(metric))
        value = reader.read(ctx) if trc is not None else None
        if value is not None:
            out.per_layer[metric] = (value, reader.UNIT)
    system.free(st)
    out.numbers = system.check(st, win, ref)
    out.attempted, out.failed = system.attempted_failed(st, win, out.numbers)
    return out


def result_line(spec, out, limits: Dict[str, float], trace: bool) -> dict:
    import torch
    checks = {k: {"value": out.numbers[k], "limit": v}
              for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in out.per_layer.items()}
    else:
        metrics = {k: {"value": out.end_to_end[k],
                       "unit": spec.end_to_end[k]["unit"]}
                   for k in spec.end_to_end_of(out.cell)}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": out.cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_bytecode()

    from benchmark.spec import Spec
    spec = Spec()
    cell = spec.cell(args.workload)
    limits = spec.limits(cell)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    line = result_line(spec, out, limits, bool(args.trace))
    print(f"setup {out.setup_s:.3f} s: {out.phases}", file=sys.stderr)
    for text in out.routes:
        print(text, file=sys.stderr)
    for key, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {key} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
