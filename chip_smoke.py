#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card, check it and time it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure raises and exits non-zero):
  1. the card, as nvidia-smi names it, with its power limit;
  2. build every CUDA kernel of the port from `recbox_tpu_torch/csrc/`
     (one nvcc per source, all started together) into `build/kernels/`;
  3. every kernel against its plain PyTorch version on the card, at a
     small shape, the serving path's shape and the 1M x 128 shape;
  4. the serving path: a YoutubeDNN at the repository's width
     (`configs/models/youtubednn.yaml`: dim 64, MLP 256-128-64, 1M users,
     1M items, 50-long histories) with random weights from a seed, behind a
     `RetrievalService(method="auto")` over the whole 1M-item corpus,
     queried for 8192 users at k=500 from a bf16 and from an int8 corpus,
     with the kernel launch counts reset just before and read just after;
     recall against an exact bf16 top-k oracle; seen-item exclusion;
  5. times with CUDA events (median of 5 after a warm-up): the kernel, its
     plain version, one PyTorch yardstick (torch.matmul + torch.topk, which
     the port never calls), the bound, and the service's queries/s; one
     service query under torch.profiler, for device time by kernel and
     the device's idle share.

Earlier lines of stdout carry the measurements as JSON; the line before
the last is the kernels' summary, the last one
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the H100's dense peaks (NVIDIA data sheet, SXM part) and HBM rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12

N_ITEMS, N_USERS, DIM, MAX_LEN, K = 1_000_000, 1_000_000, 64, 50, 500
N_QUERIES = 8192
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_inputs(variant, n, d, nq, gen):
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    q = torch.randn(nq, d, device="cuda", generator=gen)
    c = torch.randn(n, d, device="cuda", generator=gen)
    if variant == "int8":
        c8, scale = quantize_int8(c)
        return q, c8, scale
    return q, c.to(torch.bfloat16 if variant == "bf16" else torch.float32), None


def run_plain(q, c, k, valid, scale):
    """The plain version on the inputs the kernel sees after the wrapper's
    query cast / quantization."""
    from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk_plain
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    if c.dtype == torch.int8:
        q8, qs = quantize_int8(q)
        return mips_fused_topk_plain(q8, c, k, valid, scale, qs)
    return mips_fused_topk_plain(q.to(c.dtype), c, k, valid)


def check_kernel(variant, n, d, nq, k, gen):
    """Kernel against plain on one shape: int8 (exact s32 sums) must be
    identical; bf16/f32 per-row id sets must agree on >= 99.9% of rows and
    scores to rtol 2e-5 (another summation order can flip packed
    near-ties, whose scores differ by at most the 2^-16 packing step)."""
    from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk
    q, c, scale = make_inputs(variant, n, d, nq, gen)
    s, i = mips_fused_topk(q, c, k, row_scale=scale)
    s2, i2 = run_plain(q, c, k, n, scale)
    torch.cuda.synchronize()
    assert s.shape == (nq, k) and i.shape == (nq, k)
    assert bool(torch.isfinite(s).all()) and bool(((i >= 0) & (i < n)).all())
    same_rows = (torch.sort(i, 1).values == torch.sort(i2, 1).values
                 ).all(1).float().mean().item()
    err = (s - s2).abs().max().item()
    if variant == "int8":
        assert torch.equal(i, i2) and torch.equal(s, s2), (variant, n, d)
        tolerance = "identical ids and scores"
    else:
        assert same_rows >= 0.999, (variant, n, d, same_rows)
        torch.testing.assert_close(s, s2, rtol=2e-5, atol=1e-6)
        tolerance = "id sets on >= 99.9% of rows, scores rtol 2e-5 atol 1e-6"
    return {"variant": variant, "n": n, "d": d, "q": nq, "k": k,
            "rows_same_ids": same_rows, "max_abs_err": err,
            "tolerance": tolerance}


def check_pad_convention(variant, gen):
    """valid_items < N with all-negative scores: pad rows never win, the
    kernel equals the plain version, exhausted slots are (-inf, -1)."""
    from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk
    q, c, scale = make_inputs(variant, 50_000, 64, 64, gen)
    q = q.abs()
    c = -c.abs()
    for valid, k in [(45_000, 10), (3, 20)]:
        s, i = mips_fused_topk(q, c, k, valid_items=valid, row_scale=scale)
        s2, i2 = run_plain(q, c, k, valid, scale)
        live = min(valid, k)
        assert bool((i[:, :live] >= 0).all() & (i[:, :live] < valid).all())
        assert bool((i[:, live:] == -1).all())
        assert bool(torch.isneginf(s[:, live:]).all())
        assert bool((s[:, :live] < 0).all())
        assert torch.equal(torch.sort(i, 1).values, torch.sort(i2, 1).values)


def youtubednn_service_inputs():
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    fm = FeatureMap("youtubednn_1m", (
        FeatureSpec("user_id", "categorical", source="user",
                    vocab_size=N_USERS, embedding_dim=DIM),
        FeatureSpec("hist", "sequence", source="user",
                    vocab_size=N_ITEMS + 1, embedding_dim=DIM,
                    max_len=MAX_LEN, share_embedding="item_id",
                    padding_idx=N_ITEMS),
        FeatureSpec("item_id", "categorical", source="item",
                    vocab_size=N_ITEMS, embedding_dim=DIM)),
        query_index="user_id", corpus_index="item_id", num_items=N_ITEMS)
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, MAX_LEN + 1, N_QUERIES)
    hist = rng.integers(0, N_ITEMS, (N_QUERIES, MAX_LEN)).astype(np.int64)
    hist[np.arange(MAX_LEN)[None, :] >= lengths[:, None]] = N_ITEMS
    users = {"user_id": rng.integers(0, N_USERS, N_QUERIES).astype(np.int64),
             "hist": hist}
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int64)}
    return fm, users, corpus


def recall_vs_bf16_oracle(svc, users, ids, n=512):
    """Mean |ids ∩ exact| / k over the first n users; the oracle is an
    exact torch.topk over bf16 towers scored in f32."""
    with torch.no_grad():
        u = svc._encode(svc.model.encode_user,
                        {k: v[:n] for k, v in users.items()})
        items = svc.item_embs.to(torch.bfloat16).float()
        exact = torch.topk(u.to(torch.bfloat16).float() @ items.T, K,
                           dim=1).indices.cpu().numpy()
    return float(np.mean([len(set(ids[r].tolist()) & set(exact[r].tolist()))
                          / K for r in range(n)]))


def bound_ms(variant, n, d, nq, k):
    size = {"bf16": 2, "f32": 4, "int8": 1}[variant]
    moved = (n * d + nq * d) * size + nq * k * 8
    if variant == "int8":
        moved += n * 4
    ops = 2.0 * nq * n * d
    by_ops = ops / PEAK_OPS[variant] * 1e3
    by_bytes = moved / HBM_BYTES_S * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes \
        else "bytes"


def library_topk(q, c, scale, k, chunk=512):
    """One PyTorch formulation of the same top-k: cuBLAS scores (bf16
    matmul, or torch._int_mm for int8) and torch.topk, in query chunks."""
    out = []
    if c.dtype == torch.int8:
        from recbox_tpu_torch.ops.mips_topk import quantize_int8
        q8, qs = quantize_int8(q)
        for s in range(0, q.shape[0], chunk):
            sc = torch._int_mm(q8[s:s + chunk], c.T).float() * scale
            out.append(torch.topk(sc * qs[s:s + chunk, None], k, dim=1))
    else:
        qc = q.to(c.dtype)
        for s in range(0, q.shape[0], chunk):
            out.append(torch.topk(qc[s:s + chunk] @ c.T, k, dim=1))
    return out


def time_kernel(variant, n, d, nq, k, gen):
    from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk
    q, c, scale = make_inputs(variant, n, d, nq, gen)
    ms = cuda_ms(lambda: mips_fused_topk(q, c, k, row_scale=scale))
    plain_ms = cuda_ms(lambda: run_plain(q, c, k, n, scale))
    library_ms = cuda_ms(lambda: library_topk(q, c, scale, k))
    b_ms, b_by = bound_ms(variant, n, d, nq, k)
    return {"variant": variant, "n": n, "d": d, "q": nq, "k": k, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def breakdown(svc, users):
    """Where one steady service query's time goes: device time by kernel
    (torch.profiler, CUPTI) and the device's idle share of the call's wall
    time. Device times are null when the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile
    svc.query(users, k=K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.query(users, k=K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "by_kernel": []}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms,
            "by_kernel": [{"name": name[:90], "ms": ms, "count": n}
                          for name, ms, n in rows[:8]]}


def main() -> int:
    from recbox_tpu_torch.models.matching import YoutubeDNN
    from recbox_tpu_torch.ops import _build
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.retrieval import RetrievalService

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions are the kernels' yardstick: full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    seconds = _build.build()
    emit({"phase": "build", "seconds": seconds,
          "wall_s": time.perf_counter() - t0})
    for name, log in _build.build_logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        emit({"phase": "ptxas", "kernel": name, "usage": regs})

    # 3. kernel against plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = {}
    for variant in ("f32", "bf16", "int8"):
        for n, d, nq, k in [(50_000, 64, 64, 10), (N_ITEMS, DIM, N_QUERIES, K),
                            (N_ITEMS, 128, N_QUERIES, K)]:
            res = check_kernel(variant, n, d, nq, k, gen)
            emit({"phase": "kernel_vs_plain", **res})
            checks[(variant, n, d)] = res
        check_pad_convention(variant, gen)
    emit({"phase": "pad_convention", "ok": True})

    # 4. the serving path
    fm, users, corpus = youtubednn_service_inputs()
    model = YoutubeDNN(fm, embedding_dim=DIM, hidden_units=(256, 128, 64),
                       generator=torch.Generator(device="cuda").manual_seed(
                           SEED), device="cuda")
    t0 = time.perf_counter()
    svc = RetrievalService(model, corpus, method="auto")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    svc8 = RetrievalService(model, item_embs=svc.item_embs, method="auto",
                            quantize="int8")
    fused.reset_launches()
    results = {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        for _ in range(3):
            scores, ids = s.query(users, k=K)
        results[name] = (scores, ids)
    launches = dict(fused.launches)
    emit({"phase": "serve", "launches": launches, "corpus_encode_s": encode_s})
    assert launches["bf16"] >= 3 and launches["int8"] >= 3, launches
    recall = {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        scores, ids = results[name]
        assert scores.shape == (N_QUERIES, K) and ids.shape == (N_QUERIES, K)
        assert np.isfinite(scores).all() and (ids >= 0).all() \
            and (ids < N_ITEMS).all()
        assert (np.diff(scores, axis=1) <= 0).all()
        recall[name] = recall_vs_bf16_oracle(s, users, ids)
    emit({"phase": "recall", "k": K, "queries": 512, **recall,
          "predicted": 1 - K * 128 / (2 * N_ITEMS)})
    assert recall["bf16"] >= 0.95 and recall["int8"] >= 0.90, recall
    base_ids = results["bf16"][1]
    exclude = [base_ids[r, :3].tolist() for r in range(N_QUERIES)]
    ex_s, ex_ids = svc.query(users, k=K, exclude=exclude)
    assert ex_ids.shape == (N_QUERIES, K)
    assert not any(set(exclude[r]) & set(ex_ids[r].tolist())
                   for r in range(N_QUERIES))
    assert (ex_ids[:, :K - 3] == base_ids[:, 3:K]).mean() > 0.99
    emit({"phase": "exclude", "ok": True})

    # 5. times
    qps = {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        s.query(users, k=K)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            s.query(users, k=K)
            walls.append(time.perf_counter() - t0)
        qps[name] = N_QUERIES / statistics.median(walls)
    emit({"phase": "service_qps", "k": K, "queries": N_QUERIES,
          "items": N_ITEMS, **qps})
    for name, s in (("bf16", svc), ("int8", svc8)):
        emit({"phase": "breakdown", "variant": name, **breakdown(s, users)})
    timings = {}
    for variant in ("bf16", "int8", "f32"):
        for d in (DIM, 128):
            t = time_kernel(variant, N_ITEMS, d, N_QUERIES, K, gen)
            emit({"phase": "timing", "card": card, **t})
            timings[(variant, d)] = t

    kernels = []
    for variant in ("bf16", "int8"):
        t, c = timings[(variant, DIM)], checks[(variant, N_ITEMS, DIM)]
        kernels.append({
            "name": f"mips_fused_topk[{variant}]", "route": "cuda",
            "source": "recbox_tpu_torch/csrc/mips_fused_topk.cu",
            "replaces": "recbox_tpu/ops/pallas/mips_fused_topk.py:100",
            "launches": launches[variant], "max_abs_err": c["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "variants": ["bf16", "f32", "int8"], "matches_plain": True,
            "shape": {"n": N_ITEMS, "d": DIM, "q": N_QUERIES, "k": K}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
