#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card, check it and time it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure raises and exits non-zero):
  1. the card, as nvidia-smi names it, with its power limit;
  2. build every CUDA kernel of the port from `recbox_tpu_torch/csrc/`
     (one nvcc per source, all started together) into `build/kernels/`;
  3. every kernel against its plain PyTorch version on the card: the MIPS
     top-k (B3) at a small shape, the serving path's shape and the 1M x 128
     shape, and at 20 and 600 queries (the JAX segment plan below 1024
     queries); the packed AdaGrad update (B1) at the Criteo training shape,
     ids uniform per field as `bench.py` draws them and Zipf-skewed;
  4. the serving path: a YoutubeDNN at the repository's width
     (`configs/models/youtubednn.yaml`: dim 64, MLP 256-128-64, 1M users,
     1M items, 50-long histories) with random weights from a seed, behind a
     `RetrievalService(method="auto")` over the whole 1M-item corpus,
     queried for 8192 users at k=500 from a bf16 and from an int8 corpus,
     with the kernel launch counts reset just before and read just after;
     recall against an exact bf16 top-k oracle; seen-item exclusion;
  5. the training path: `PackedEmbeddingTrainer(DeepFM)` at `bench.py`'s
     Criteo width (26 categorical fields of 100,000 ids, 13 numeric, dim
     64, MLP 1024-512-256, feature-major, bf16 compute, batch 32768) on a
     label drawn from a fixed random logistic model over four fields, with
     B1's launch count reset just before and read just after; falling
     loss, examples/s, one step under torch.profiler, held-out AUC/logloss;
  6. times with CUDA events (median after a warm-up): each kernel, its
     plain version, one PyTorch yardstick (torch.matmul + torch.topk for
     B3, the `index_add_` scatter B1 absorbs; the port calls neither), the
     bound, and the service's queries/s; one service query under
     torch.profiler, for device time by kernel and the device's idle share.

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

# bench.py's Criteo training shape (`bench.py:160-162`)
NUM_CAT, NUM_NUM, VOCAB, BATCH, HIDDEN = 26, 13, 100_000, 32768, \
    (1024, 512, 256)
WARMUP_STEPS, TIMED_STEPS = 3, 12
# where the segment-plan, B1 and training phases put their tensors (a CPU
# rehearsal of the script's control flow may point it elsewhere)
DEVICE = "cuda"


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
    query cast / quantization, with the wrapper's (JAX's) segment plan."""
    from recbox_tpu_torch.ops.mips_fused_topk import (
        mips_fused_topk_plain, segment_plan,
    )
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    sub, _ = segment_plan(c.dtype, c.shape[0], c.shape[1], q.shape[0], k)
    assert k <= -(-c.shape[0] // sub) * (sub // 128)
    if c.dtype == torch.int8:
        q8, qs = quantize_int8(q)
        return mips_fused_topk_plain(q8, c, k, valid, scale, qs, sub)
    return mips_fused_topk_plain(q.to(c.dtype), c, k, valid, sub_rows=sub)


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


def check_segment_plan(gen):
    """B3 below 1024 queries, where the JAX plan's sub-chunks are not 1024
    rows: 20 queries (16384 rows, 128 segments) and 600 (1664 rows, 13
    segments) over 1M x 64 bf16. Values are small integers, so every order
    of summation is exact and kernel and plain version must return the same
    ids and scores, ties included."""
    from recbox_tpu_torch.ops.mips_fused_topk import (
        mips_fused_topk, segment_plan,
    )
    c = torch.randint(-4, 5, (N_ITEMS, DIM), generator=gen,
                      device=DEVICE).to(torch.bfloat16)
    out = []
    for nq in (20, 600):
        q = torch.randint(-4, 5, (nq, DIM), generator=gen,
                          device=DEVICE).float()
        sub, n_cand = segment_plan(c.dtype, N_ITEMS, DIM, nq, K)
        s, i = mips_fused_topk(q, c, K)
        s2, i2 = run_plain(q, c, K, N_ITEMS, None)
        torch.cuda.synchronize()
        assert torch.equal(i, i2) and torch.equal(s, s2), nq
        assert bool(((i >= 0) & (i < N_ITEMS)).all())
        out.append({"q": nq, "sub_rows": sub, "segments": sub // 128,
                    "candidates": n_cand, "ids_equal": True})
    return out


B1_DIMS, B1_ACC, B1_USED, B1_LR, B1_EPS = (DIM, 1), (DIM + 1, DIM + 2), \
    DIM + 3, 0.05, 1e-8


def b1_inputs(gen, ids_kind):
    """A (2.6M, 128) pack laid out as the trainer lays out DeepFM's
    [64 embedding | 1 linear | 2 accumulators | 0 pad], 851,968 ids (one per
    field and example), the gathered rows G and bf16 row gradients."""
    rows = NUM_CAT * VOCAB
    pack = torch.zeros(rows, 128, device=DEVICE)
    pack[:, :DIM + 1] = 1e-2 * torch.randn(rows, DIM + 1, generator=gen,
                                           device=DEVICE)
    pack[:, DIM + 1:B1_USED] = torch.rand(rows, 2, generator=gen,
                                          device=DEVICE)
    rng = np.random.default_rng(SEED)
    if ids_kind == "uniform":          # bench.py: uniform per field
        local = rng.integers(0, VOCAB, (NUM_CAT, BATCH))
    else:                              # Zipf-skewed: heavy duplicates
        local = (rng.zipf(1.2, (NUM_CAT, BATCH)) - 1) % VOCAB
    ids = torch.from_numpy(
        (local + VOCAB * np.arange(NUM_CAT)[:, None]).reshape(-1).astype(
            np.int32)).to(DEVICE)
    G = pack.index_select(0, ids)
    n = ids.shape[0]
    grads = [(1e-3 * torch.randn(n, d, generator=gen, device=DEVICE)).to(
        torch.bfloat16) for d in B1_DIMS]
    return pack, ids, G, grads


def b1_call(fn, pack, ids, G, grads):
    return fn(pack, ids, G, grads, B1_LR, dims=B1_DIMS, acc_cols=B1_ACC,
              used=B1_USED, eps=B1_EPS)


def check_b1(gen, ids_kind):
    """B1 against its plain version after one update of the full pack.
    Rows hit once: rtol 1e-5, atol 1e-7 (only the mean's sum order
    differs). A row hit c > 1 times sums its c updates with atomics in a
    run-dependent order, so there each entry may differ by the rounding of
    that order (the plain version's `index_add_` sums with atomics too),
    bounded by c * 2^-23 * (|pre| + sum of the |updates|) on top."""
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_,
    )
    pack, ids, G, grads = b1_inputs(gen, ids_kind)
    pre, plain = pack.clone(), pack.clone()
    b1_call(packed_adagrad_update_, pack, ids, G, grads)
    b1_call(packed_adagrad_update_plain_, plain, ids, G, grads)
    torch.cuda.synchronize()
    count = torch.bincount(ids.long(), minlength=pack.shape[0])
    touched = count > 0
    once, dup = count == 1, count > 1
    err = (pack - plain).abs()
    assert torch.equal(pack[~touched], plain[~touched])
    torch.testing.assert_close(pack[once], plain[once], rtol=1e-5, atol=1e-7)
    upd = fused_adagrad_delta_plain(G, grads, B1_LR, dims=B1_DIMS,
                                    acc_cols=B1_ACC, used=B1_USED,
                                    store_w=128, eps=B1_EPS)
    mag = pre.abs().index_add_(0, ids, upd.abs())[dup]
    bound = (count[dup, None].float() * 2.0 ** -23 * mag
             + 1e-5 * plain[dup].abs() + 1e-7)
    assert bool((err[dup] <= bound).all()), float((err[dup] - bound).max())
    return {"ids": ids_kind, "n": int(ids.shape[0]),
            "unique": int(touched.sum()), "dup_rows": int(dup.sum()),
            "max_count": int(count.max()), "max_abs_err": float(err.max()),
            "max_abs_err_once": float(err[once].max()),
            "tolerance": "rows hit once rtol 1e-5 atol 1e-7; a row hit c "
                         "times within c*2^-23*(|pre|+sum|upd|) + 1e-5*|x| "
                         "+ 1e-7"}


def b1_bound_ms(ids, grads):
    """Each input read once, each output written once: ids, the slots'
    accumulators in G, the gradients, and a read-modify-write of the used
    columns of every touched pack row; against ~6 f32 operations an
    element at 67 TFLOP/s."""
    n = ids.shape[0]
    unique = int(torch.unique(ids).numel())
    moved = n * (ids.element_size() + 4 * len(B1_DIMS)) \
        + sum(g.numel() * g.element_size() for g in grads) \
        + unique * B1_USED * 4 * 2
    by_bytes = moved / HBM_BYTES_S * 1e3
    by_ops = 6.0 * n * sum(B1_DIMS) / PEAK_OPS["f32"] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations", moved


def time_b1(gen):
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_,
    )
    pack, ids, G, grads = b1_inputs(gen, "uniform")
    upd = fused_adagrad_delta_plain(G, grads, B1_LR, dims=B1_DIMS,
                                    acc_cols=B1_ACC, used=B1_USED,
                                    store_w=128, eps=B1_EPS)
    ms = cuda_ms(lambda: b1_call(packed_adagrad_update_, pack, ids, G,
                                 grads), reps=20)
    plain_ms = cuda_ms(lambda: b1_call(packed_adagrad_update_plain_, pack,
                                       ids, G, grads), reps=20)
    # the scatter alone that B1 absorbs, given the finished operand
    library_ms = cuda_ms(lambda: pack.index_add_(0, ids, upd), reps=20)
    b_ms, b_by, moved = b1_bound_ms(ids, grads)
    return {"n": int(ids.shape[0]), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": moved}


def criteo_trainer(seed):
    """PackedEmbeddingTrainer over bench.py's DeepFM, as `bench.py:595-626`
    builds it: BCE, Adam 1e-3 with clip 10, AdaGrad on the packs."""
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.ranking import DeepFM
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import (
        PackedEmbeddingTrainer, TrainerConfig,
    )
    feats = tuple(
        FeatureSpec(f"c{i}", "categorical", vocab_size=VOCAB,
                    embedding_dim=DIM) for i in range(NUM_CAT)) + tuple(
        FeatureSpec(f"n{i}", "numeric", embedding_dim=DIM)
        for i in range(NUM_NUM))
    fm = FeatureMap("criteo_bench", feats, labels=("click",))
    model = DeepFM(fm, embedding_dim=DIM, hidden_units=HIDDEN,
                   compute_dtype="bfloat16", feature_major_compute=True,
                   generator=torch.Generator(device=DEVICE).manual_seed(seed),
                   device=DEVICE)
    cfg = TrainerConfig(learning_rate=1e-3, grad_clip_norm=10.0, epochs=1,
                        seed=seed)
    return PackedEmbeddingTrainer(
        model, lambda o, b: binary_crossentropy(o, b["click"]), cfg,
        device=DEVICE)


class CriteoBatches:
    """Batches on the card: ids uniform per field (as `bench.py` draws
    them), numeric N(0, 1), and a click drawn from a fixed logistic model
    whose logit is the sum of per-id weights N(0, 1) of fields c0..c3."""

    def __init__(self, seed):
        self.gen = torch.Generator(device=DEVICE).manual_seed(seed)
        self.weights = torch.randn(4, VOCAB, generator=self.gen,
                                   device=DEVICE)

    def __call__(self):
        g = self.gen
        batch = {f"c{i}": torch.randint(0, VOCAB, (BATCH,), generator=g,
                                        device=DEVICE, dtype=torch.int32)
                 for i in range(NUM_CAT)}
        batch.update({f"n{i}": torch.randn(BATCH, generator=g, device=DEVICE)
                      for i in range(NUM_NUM)})
        logit = sum(self.weights[f, batch[f"c{f}"].long()] for f in range(4))
        batch["click"] = (torch.rand(BATCH, generator=g, device=DEVICE)
                          < torch.sigmoid(logit)).float()
        return batch


def train_breakdown(trainer, batch):
    """Device time by kernel of one steady train step (torch.profiler),
    grouped by kernel name (the gather, GEMMs, B1, the rest); the device
    timeline's span of each of the trainer's phases (gather, forward,
    backward, Adam, row update); and the device's idle share of the step's
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    phase_names = ("trainer::", "packed::")
    events = prof.key_averages()
    # the trainer's record_function ranges also show as device rows: the
    # span of the device timeline from their first kernel to their last,
    # gaps included; they are reported apart and kept out of the sums
    phases = {e.key: e.device_time_total / 1e3 for e in events
              if e.key.startswith(phase_names)}
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(phase_names)]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    groups = {"b1_packed_adagrad_update": 0.0, "gemm": 0.0,
              "gather_index_select": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        if "packed_adagrad_update" in low:
            groups["b1_packed_adagrad_update"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "sm90", "cutlass",
                                    "xmma", "splitk")):
            groups["gemm"] += ms
        elif "gather" in low or ("index" in low and "select" in low):
            groups["gather_index_select"] += ms
        else:
            groups["other"] += ms
    if device_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "groups": None, "phase_span_ms": None, "by_kernel": []}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms, "groups": groups,
            "phase_span_ms": phases,
            "by_kernel": [{"name": name[:90], "ms": ms, "count": n}
                          for name, ms, n in rows[:14]]}


def train_criteo():
    """The training path at full width: the counts of B1 reset just before
    the steps and read just after."""
    from recbox_tpu_torch.evaluation import auc_score, log_loss
    from recbox_tpu_torch.ops import packed_delta

    trainer = criteo_trainer(SEED)
    data = CriteoBatches(SEED + 1)
    batches = [data() for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    held_out = data()
    t0 = time.perf_counter()
    trainer.init(batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    (pname, pack), = trainer.packs.items()
    assert tuple(pack.shape) == (NUM_CAT * VOCAB, 128), pack.shape
    packed_delta.reset_launches()
    losses, step_ms = [], []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(batch))
        end.record()
        if i >= WARMUP_STEPS:
            step_ms.append((start, end))
    torch.cuda.synchronize()
    launches = packed_delta.launches["packed_adagrad_update"]
    losses = [float(x) for x in losses]
    step_ms = [s.elapsed_time(e) for s, e in step_ms]
    assert launches == len(batches), (launches, len(batches))
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    labels = held_out.pop("click").cpu().numpy()
    logits = trainer.predict([held_out])
    assert logits.shape == (BATCH,) and np.isfinite(logits).all()
    p = 1 / (1 + np.exp(-logits.astype(np.float64)))
    return trainer, batches[-1], {
        "pack": pname, "pack_shape": list(pack.shape),
        "rows_per_step": NUM_CAT * BATCH, "init_s": init_s,
        "losses": losses, "launches": launches,
        "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
        "examples_per_s": BATCH / statistics.median(step_ms) * 1e3,
        "held_out_auc": auc_score(labels, p),
        "held_out_logloss": log_loss(labels, p),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def main() -> int:
    from recbox_tpu_torch.models.matching import YoutubeDNN
    from recbox_tpu_torch.ops import _build
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops import packed_delta
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
    for res in check_segment_plan(gen):
        emit({"phase": "segment_plan_vs_plain", **res})
    b1_checks = {}
    for ids_kind in ("uniform", "zipf"):
        b1_checks[ids_kind] = check_b1(gen, ids_kind)
        emit({"phase": "b1_vs_plain", **b1_checks[ids_kind]})
    emit({"phase": "b1_check_launches",
          "launches": packed_delta.launches["packed_adagrad_update"]})

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
    del results, base_ids, ex_s, ex_ids

    # 5. the training path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, last_batch, train = train_criteo()
    emit({"phase": "train", "card": card, "wall_s": time.perf_counter() - t0,
          **train})
    emit({"phase": "train_breakdown", "card": card,
          **train_breakdown(trainer, last_batch)})
    del trainer, last_batch

    # 6. times
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
    b1_time = time_b1(gen)
    emit({"phase": "timing", "card": card, "kernel": "packed_adagrad_update",
          **b1_time})
    timings = {}
    for variant in ("bf16", "int8", "f32"):
        for d in (DIM, 128):
            t = time_kernel(variant, N_ITEMS, d, N_QUERIES, K, gen)
            emit({"phase": "timing", "card": card, **t})
            timings[(variant, d)] = t
    for variant in ("bf16", "int8"):     # the JAX plan below 1024 queries
        for nq in (20, 600):
            emit({"phase": "timing", "card": card,
                  **time_kernel(variant, N_ITEMS, DIM, nq, K, gen)})

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
    kernels.append({
        "name": "packed_adagrad_update", "route": "cuda",
        "source": "recbox_tpu_torch/csrc/packed_delta.cu",
        "replaces": "recbox_tpu/ops/pallas/packed_delta.py:62",
        "launches": train["launches"],
        "max_abs_err": b1_checks["uniform"]["max_abs_err"],
        "ms": b1_time["ms"], "plain_ms": b1_time["plain_ms"],
        "bound_ms": b1_time["bound_ms"], "bound_by": b1_time["bound_by"],
        "library_ms": b1_time["library_ms"],
        "library": "pack.index_add_(0, ids, operand), the scatter alone",
        "matches_plain": True,
        "shape": {"pack": [NUM_CAT * VOCAB, 128], "rows": NUM_CAT * BATCH,
                  "slots": list(B1_DIMS), "grads": "bf16"}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
