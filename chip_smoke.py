#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card, check it and time it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure raises and exits non-zero):
  1. the card, as nvidia-smi names it, with its power limit;
  2. build every CUDA kernel of the port from `recbox_tpu_torch/csrc/`
     (one nvcc per source, all started together) into `build/kernels/`;
     each kernel's registers and spills as ptxas gives them (B4's
     wgmma route at D = 64 and 128, whose packed instantiations are B3's
     stage (a), B5's selection, B3's selection with its epilogue, B2's
     ce_fwd / ce_bwd at depth 64 and 128, B1 and B6 must spill nothing);
  3. every kernel against its plain PyTorch version on the card: the MIPS
     top-k (B3) on N(0, 1) data at a small shape, the serving path's shape
     and the 1M x 128 shape (f32 and the small shape on B4's tile route),
     and at 20 and 600 queries (the JAX segment plan below 1024 queries, on
     the tile route), integer data bit for bit; B3 on integer data bit for
     bit, bf16 and int8, on the wgmma route: at 1M x 64 and 1M x 128, at
     each plan of the route over 50,000 x 300, and over a corpus of repeated
     blocks whose tied winners must come out position ascending; the packed
     AdaGrad update (B1) at the Criteo training shape, ids uniform per field
     as `bench.py` draws them and Zipf-skewed, and at each layout of
     `B1_LAYOUTS` (every instantiation of the kernel), where the updates
     themselves are held to the plain version's;
  3b. kernel B2 (flash-CE) against its plain versions: bench.py's 1M-item
     SASRec shape (B=1024, V=1M, D=64), a ragged one (1000, 100,003, 100),
     B = 200, 500, 1500 and 8192 at V = 100,003 (clusters of one and two
     blocks, a ragged pass, eight passes), D = 128 at B = 1024, weights with
     zeros, all-160 and all--40 logits, the multinomial variant (B=256,
     V=100,000, 20 positives); each kernel call twice, bit for bit;
  3c. the candidate kernels and the sequence pool against their plain
     versions: B4 (`mips_segment_candidates`, packed bf16, packed int8,
     unpacked bf16) at the profiling shape of `tools/prof_mips_batched.py`
     (N=1M, D=128, Q=8192, the 1024-query plan, on the wgmma route) and at
     D = 64,
     integer-valued inputs bit for bit and N(0, 1) ones up to packed
     near-ties; every instantiation (f32 too) on integer data at 3000 rows
     x 20 queries (the tile route, the packed ones split into runs merged
     by atomic max) and 100,000 x 1024, and bf16 packed and unpacked and
     int8 at each plan of the wgmma route (query tiles of 8192, 4096, 2048
     and 1024: 1, 2, 4 and 8 segments a sub-chunk) over 50,000 rows x 300
     queries at D = 128 and 64, bit for bit; B5 (the radix selection) at
     the merge-only (7812, 1024) shape, k=500 and 100, the full path's
     (7936, 8192) with ties, the merge-only shape row-major (ids and
     positions), a windowed (40,000, 64) with ties and k = C at 16384, bit
     for bit; B6 (`seq_embedding_pool`) at V=1M, B=8192, L=50, D=128
     (mean, sum) and 64 over Zipf ids with ~20% pads and rows of pads, over
     uniform ids (D=128 and 64), and with ids out of range (NaN rows on
     both), each call repeated bit for bit;
  4. the serving path: a YoutubeDNN at the repository's width
     (`configs/models/youtubednn.yaml`: dim 64, MLP 256-128-64, 1M users,
     1M items, 50-long histories) with random weights from a seed, behind a
     `RetrievalService(method="auto")` over the whole 1M-item corpus,
     queried for 8192 users at k=500 from a bf16 and from an int8 corpus,
     with the kernel launch counts reset just before and read just after
     (each query one launch of B3's stage (a) on the wgmma route and one of
     its selection); recall against an exact bf16 top-k oracle; successive
     results in memory of their own; seen-item exclusion;
  4b. the candidate paths, with B4 (by variant and by route), B5 and B6's
     counts reset just before and read just after: `pallas_mips_topk` at
     B4's shape packed (default merge), unpacked through B5
     (`merge='bitonic'`, ids equal to the exact merge's) and over int8 rows,
     recall against an exact f32 top-k over 512 queries, every call on
     B4's wgmma route; `seq_embedding_pool` at B6's shapes; then each
     `pallas_mips_topk` call timed (ms per 8192 queries, median of 3)
     beside its candidate generation alone; then the rest of
     `BruteForceMIPS` behind `RetrievalService` on phase 4's corpus
     ('refined', int8 'approx', int8 'refined'), recall against an exact
     f32 oracle, refined scores against the f32 dot products, queries/s;
  5. the training path: `PackedEmbeddingTrainer(DeepFM)` at `bench.py`'s
     Criteo width (26 categorical fields of 100,000 ids, 13 numeric, dim
     64, MLP 1024-512-256, feature-major, bf16 compute, batch 32768) on a
     label drawn from a fixed random logistic model over four fields, with
     B1's launch count reset just before and read just after; falling
     loss, examples/s, one step under torch.profiler, held-out AUC/logloss;
  5b. the sequential training path: `Trainer(SASRec,
     train_method='fused_ce_loss')` at `bench.py`'s 1M-item shape (V=1M,
     L=50, d=64, 2 layers, 2 heads, dropout 0.1, bf16, batch 1024, Adam
     1e-3 with clip 10), 3 + 12 steps on one batch with B2's counts reset
     just before and read just after (one forward and one backward a
     step), falling loss, examples/s, one step under torch.profiler; the
     CPU Markov learning test trained on the card (hit@1 > 0.8); the 60k
     regime through `full_scores` against `fused_ce_loss`;
  5c. training to a result, DeepFM: phase 5's trainer through `fit` for 2
     epochs of 24 batches (phase 5's logistic label), 8 steps a
     `train_steps_fused` call (one CUDA graph of the step, replayed a
     step), `CTREvaluator` (AUC, logloss) on 4 held-out batches, B1's
     count reset just before and read just after (one launch a step); a
     plateau forced at the second evaluation, after which the lr and the
     embedding lr are a tenth and the step, captured again, moves the pack
     and the weights as an eager step at the new lr does; `save`, `load`
     into a fresh trainer, `predict` bit for bit; checkpoint bytes and
     seconds, capture and `_capture_best` seconds; held-out AUC above 0.5
     at the best evaluation; ms a step of eager `train_step` against replayed
     steps on the same batches, 6 blocks of 8 steps a side in turns; one
     fused step under torch.profiler;
  5d. training to a result, SASRec at V = 1M: phase 5b's trainer through
     `fit` for 2 epochs of 16 batches (drawn as `bench.py:434-438` draws
     one), 8 steps a fused call, `evaluate_retrieval` each epoch over 4096
     held-out users (full sort over the 1M items, chunks clamped to 268
     users), B2's counts reset just before and read just after (one
     forward and one backward a step); two replays draw different dropout
     masks; a replayed step and an eager one with the same dropout draws
     give the same loss and move the 1M x 64 table and an encoder weight
     alike; eager against fused ms a step (as in 5c); one fused step
     profiled;
  5e. the quality exits on the card: `recbox_tpu_torch.tools.quality_exit`
     (the JAX package's DeepFM synthctr and SASRec synthseq parity runs,
     and DCNv2 / xDeepFM in DeepFM's place) at seeds 2024, 1, 2, 3, 4,
     valid and test metrics a seed and the medians of the test metrics;
     then SASRec at seed 2024 through B2's loss and 8-step graphs, one
     B2 forward and backward a step, its test metrics within 0.02 of the
     median of the five;
  5f. matching from training to serving: LightGCN at `bench.py`'s width
     (30,000 users, 41,000 items, 1M interactions with 64 planted blocks,
     90% of a user's items from its block, the blocks scattered over the
     ids; 10% of each user's items held out; d = 64, 3 hops), trained by
     `fit` for 2 epochs of `MatchingLoader` batches (2048 rows, one
     uniform negative drawn anew each epoch) under BPR and Adam 1e-3, 8
     steps a `train_steps_fused` call (one CUDA graph of the step);
     `RetrievalEvaluator` (Recall@20, NDCG@20, full sort) over 4096
     held-out users each epoch, the last above 10x chance (20 / 41,000),
     then once with protocol 'uni100'; eager against replayed ms a step
     (6 blocks of 8 steps a side, in turns) and one replayed step profiled
     (the hops' gathers and `index_add_` beside Adam); then
     `RetrievalService.from_trainer` over the trained towers, queried for
     8192 users at k = 20 from a bf16 and an int8 corpus, B3's and B4's
     counts reset just before and read just after each query (one stage
     (a) launch on the `wgmma` route and one selection a query), recall
     against an exact bf16 top-k over 512 users (>= 0.95 / 0.90),
     queries/s, and B3 timed and checked against its plain version at this
     shape;
  5g. matching on the card: `SparseEmbeddingTrainer(MF)` through 16 eager
     steps against two 8-step `train_steps_fused` calls (a CUDA graph) from
     the same weights, then served by `RetrievalService.from_trainer`; the
     matching exits, `tools/quality_exit.py`'s MF-BPR and LightGCN on synth
     at seeds 2024, 1, 2, 3, 4 and MF-BPR on ml1m_scale at seed 2024, valid
     and test metrics a seed and the medians;
  5h. the CTR zoo through B1 at the Criteo width (phase 5's 26 + 13
     fields, batch 32768, the logistic label of phase 5):
     `run_ranking_experiment` over DCNv2 at `configs/models/dcnv2.yaml`'s
     widths (dim 16, f32, 3 cross layers, MLP 400-400, 'parallel') with
     `trainer: packed`, 1 epoch of 24 batches at 8 steps a fused call,
     `CTREvaluator` on 4 held-out batches (AUC above 0.5), B1's count
     reset just before and read just after (one launch a step); the same
     `PackedEmbeddingTrainer(DCNv2)` eager against replayed (6 blocks of 8
     steps a side, in turns), a replayed step equal to an eager one (the
     pack and a cross weight), one replayed step profiled (GEMMs, the
     gather, B1, copies, elementwise; idle share); B1 at DCNv2's one-slot
     layout checked and timed against its plain version, its bound and
     `index_add_`; xDeepFM at `configs/models/xdeepfm.yaml`'s widths for
     16 steps (falling loss, one B1 launch a step, ms a replayed step),
     and B1 at its 16 + 1 layout checked and timed as the one-slot one;
  5i. the cascade on the card: `run_cascade_experiment("ml1m_scale",
     matcher="MF", ranker="DCN", reranker="PRM")` over ml1m_scale (6040 x
     3706, 834,915 interactions) at `tools/cascade_ml1m_scale.py`'s knobs,
     seed 2024: every metric and the seconds of each stage;
  6. times with CUDA events (median after a warm-up; B5, B6 and their
     yardsticks over runs of 20 calls queued behind a spin kernel, so the
     host's launch work is not timed): each kernel, its
     plain version, one PyTorch yardstick (torch.matmul + torch.topk for
     B3, the `index_add_` scatter B1 absorbs (B1 over uniform and Zipf
     ids), a bf16 matmul into 2 GB of logits + F.cross_entropy for B2,
     cuBLAS scores + segment amax for B4, torch.topk for B5,
     F.embedding_bag for B6, over Zipf ids that stay in L2 and uniform
     ones that reach HBM; the port calls none of them), the
     bound (B2's counting its exps), B3's two stages alone and its stage (a) on
     the tile route, B4 at D = 128 and 64 with its tile route on the same
     inputs beside its wgmma route, and the service's queries/s; one service query under torch.profiler,
     for device time by kernel, the results' copy to the host and the
     device's idle share.

Earlier lines of stdout carry the measurements as JSON; the line before
the last is the kernels' summary, the last one
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
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


def ptxas_usage(log: str) -> dict:
    """Registers and spills of each entry function in an ``nvcc -Xptxas
    -v`` log: {mangled name: {"registers", "spill_stores", "spill_loads",
    "stack"}} (bytes for the last three)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[name].update(stack=nums[0], spill_stores=nums[1],
                             spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
    return out


def usage_of(logs: dict, lib: str, fragment: str) -> list:
    """`ptxas_usage` of library ``lib``'s entry functions whose (mangled)
    name holds ``fragment``, as a list of {"function", ...} entries."""
    usage = ptxas_usage(logs.get(lib, ""))
    return [{"function": name, **u} for name, u in sorted(usage.items())
            if fragment in name]


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call.
    With ``inner`` > 1, around a run of that many calls queued behind a
    ~10 ms spin kernel, divided by ``inner``: a call of tens of microseconds
    then times the device's work alone, not the host's launch work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if inner > 1:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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


def b3_counts():
    """B3's launches so far: its selection (one a call, counted by B3's
    wrapper) and its stage (a), B4's packed kernel, by route (counted by
    B4's)."""
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops import mips_topk
    return {"select": sum(fused.launches.values()),
            **mips_topk.route_launches}


def b3_route_taken(before):
    """The route of B3's stage (a) in the one call since the counts were
    ``before``; asserts that call made one launch of each stage."""
    now = b3_counts()
    diff = {key: now[key] - before[key] for key in now}
    assert diff["select"] == 1 and diff["wgmma"] + diff["tile"] == 1, diff
    return "wgmma" if diff["wgmma"] else "tile"


def check_kernel(variant, n, d, nq, k, gen):
    """Kernel against plain on one shape: int8 (exact s32 sums) must be
    identical; bf16/f32 per-row id sets must agree on >= 99.9% of rows and
    scores to rtol 2e-5 (another summation order can flip packed
    near-ties, whose scores differ by at most the 2^-16 packing step)."""
    from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk
    q, c, scale = make_inputs(variant, n, d, nq, gen)
    before = b3_counts()
    s, i = mips_fused_topk(q, c, k, row_scale=scale)
    route = b3_route_taken(before)
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
            "route": route, "rows_same_ids": same_rows, "max_abs_err": err,
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


def recall_vs_bf16_oracle(svc, users, ids, n=512, k=K):
    """Mean |ids ∩ exact| / k over the first n users; the oracle is an
    exact torch.topk over bf16 towers scored in f32."""
    with torch.no_grad():
        u = svc._encode(svc.model.encode_user,
                        {key: v[:n] for key, v in users.items()})
        items = svc.item_embs.to(torch.bfloat16).float()
        exact = torch.topk(u.to(torch.bfloat16).float() @ items.T, k,
                           dim=1).indices.cpu().numpy()
    return recall_at(ids[:n], exact)


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
        # cuBLASLt's int8 product wants the corpus rows a multiple of 64:
        # zero rows past N, their scores dropped before the top-k
        n = c.shape[0]
        c8 = torch.nn.functional.pad(c, (0, 0, 0, -n % 64))
        for s in range(0, q.shape[0], chunk):
            sc = torch._int_mm(q8[s:s + chunk], c8.T)[:, :n].float() * scale
            out.append(torch.topk(sc * qs[s:s + chunk, None], k, dim=1))
    else:
        qc = q.to(c.dtype)
        for s in range(0, q.shape[0], chunk):
            out.append(torch.topk(qc[s:s + chunk] @ c.T, k, dim=1))
    return out


def b3_stages(q, c, scale, k):
    """B3's two launches as separate calls on the inputs its wrapper would
    hand them: stage (a) (B4's packed kernel, on the route the wrapper
    takes) into candidate-major winners, and stage (b) (the selection with
    B3's epilogue) from them; and stage (a) forced onto B4's tile route,
    B3's first design of it, for a comparison in the same run."""
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops.bitonic_topk import select_plan
    from recbox_tpu_torch.ops.mips_topk import (
        _candidates_cuda, quantize_int8,
    )
    (n, d), nq = c.shape, q.shape[0]
    sub = fused.segment_plan(c.dtype, n, d, nq, k)[0]
    q_scale = None
    if c.dtype == torch.int8:
        q, q_scale = quantize_int8(q)
    else:
        q = q.to(c.dtype)
    n_cand = -(-n // sub) * (sub // 128)
    win = torch.empty((n_cand, nq), device=c.device)
    out_s = torch.empty((nq, k), device=c.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=c.device)
    qb, window, kpt, p = select_plan(n_cand, k)
    lib = fused._kernel_lib()

    def stage_a():
        _candidates_cuda(q, c, n, True, scale, sub, win, None)

    def stage_b():
        rc = lib.recbox_mips_select_winners(
            win.data_ptr(), None if q_scale is None else q_scale.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), nq, n_cand, k, p, window, qb,
            kpt, sub, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    return stage_a, stage_b, lambda: b4_tile_route(q, c, scale, True, sub)


def time_kernel(variant, n, d, nq, k, gen):
    """B3 (both launches, through its wrapper), its plain version, the
    library formulation and the bound; at the serving query count also each
    stage alone (the selection over runs of 20 calls behind a spin kernel)
    and stage (a) on the tile route."""
    from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk
    q, c, scale = make_inputs(variant, n, d, nq, gen)
    ms = cuda_ms(lambda: mips_fused_topk(q, c, k, row_scale=scale))
    plain_ms = cuda_ms(lambda: run_plain(q, c, k, n, scale))
    library_ms = cuda_ms(lambda: library_topk(q, c, scale, k))
    b_ms, b_by = bound_ms(variant, n, d, nq, k)
    out = {"variant": variant, "n": n, "d": d, "q": nq, "k": k, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
           "bound_by": b_by}
    if variant != "f32" and nq == N_QUERIES:
        stage_a, stage_b, tile_a = b3_stages(q, c, scale, k)
        out.update(stage_a_ms=cuda_ms(stage_a),
                   stage_b_ms=cuda_ms(stage_b, reps=11, inner=20),
                   tile_route_stage_a_ms=cuda_ms(tile_a, reps=3))
    return out


def breakdown(svc, users):
    """Where one steady service query's time goes: device time by kernel
    (torch.profiler, CUPTI), the copy of the results to the host among
    them, and the device's idle share of the call's wall time. Device
    times are null when the profiler saw no device work."""
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
                "copy_ms": None, "by_kernel": []}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms,
            "copy_ms": sum(ms for name, ms, _ in rows if "DtoH" in name),
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
        before = b3_counts()
        s, i = mips_fused_topk(q, c, K)
        route = b3_route_taken(before)
        s2, i2 = run_plain(q, c, K, N_ITEMS, None)
        torch.cuda.synchronize()
        assert torch.equal(i, i2) and torch.equal(s, s2), nq
        assert bool(((i >= 0) & (i < N_ITEMS)).all())
        assert route == "tile", (nq, route)
        out.append({"q": nq, "sub_rows": sub, "segments": sub // 128,
                    "candidates": n_cand, "route": route,
                    "ids_equal": True})
    return out


# B3 on integer-valued towers: the serving shape at D = 64 and 128; each
# plan of the wgmma route (`B4_PLAN_TILES`) over 50,000 rows x 300 queries;
# a corpus of one 1024-row block repeated 128 times, at 1024 queries
B3_TIES = (131_072, 1024)


def b3_integer_inputs(gen, variant, n, d, nq, period=None):
    """Integer-valued queries (f32, as the service hands them over) and a
    bf16 or int8 (`quantize_int8`) corpus; with ``period`` the corpus
    repeats its first ``period`` rows."""
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    q = torch.randint(-4, 5, (nq, d), generator=gen, device=DEVICE).float()
    c = torch.randint(-4, 5, (period or n, d), generator=gen,
                      device=DEVICE).float()
    if period:
        c = c.repeat(n // period, 1)
    if variant == "int8":
        c8, scale = quantize_int8(c)
        return q, c8, scale
    return q, c.to(torch.bfloat16), None


def check_b3_integer(gen):
    """B3 against its plain version on integer-valued data, bit for bit in
    ids and scores, bf16 and int8, each call on the wgmma route with one
    launch of each stage: the serving shape (1M x 64 and 1M x 128, Q=8192,
    k=500); each plan of the route (query tiles of 8192, 4096, 2048, 1024:
    1, 2, 4, 8 segments a sub-chunk) over 50,000 x 300 with the last 37
    rows past valid_items, k=100; and `B3_TIES`, where every packed winner
    recurs in all 128 sub-chunks, so the top 500 are runs of equal packed
    winners that must come out candidate position ascending."""
    from recbox_tpu_torch.ops.mips_fused_topk import (
        _mips_fused_topk_cuda, mips_fused_topk_plain, segment_plan,
    )
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    cases = [("serving", N_ITEMS, d, N_QUERIES, K, None) for d in (DIM, 128)]
    cases += [("plan", B4_PLAN_SHAPE[0], DIM, B4_PLAN_SHAPE[1], 100, tile)
              for tile in B4_PLAN_TILES]
    cases += [("ties", B3_TIES[0], DIM, B3_TIES[1], K, None)]
    out = []
    for kind, n, d, nq, k, tile in cases:
        for variant in ("bf16", "int8"):
            q, c, scale = b3_integer_inputs(gen, variant, n, d, nq,
                                            1024 if kind == "ties" else None)
            valid = n - 37 if kind == "plan" else n
            sub = segment_plan(c.dtype, n, d, tile or nq, k,
                               query_tile=tile or 1024)[0]
            if variant == "int8":
                q, q_scale = quantize_int8(q)
            else:
                q, q_scale = q.to(c.dtype), None
            before = b3_counts()
            s, i = _mips_fused_topk_cuda(q, c, k, valid, scale, q_scale, sub)
            route = b3_route_taken(before)
            s2, i2 = mips_fused_topk_plain(q, c, k, valid, scale, q_scale,
                                           sub)
            torch.cuda.synchronize()
            assert route == "wgmma", (kind, variant, d, route)
            assert torch.equal(s, s2) and torch.equal(i, i2), \
                (kind, variant, d, tile)
            res = {"case": kind, "variant": variant, "n": n, "d": d, "q": nq,
                   "k": k, "sub_rows": sub, "route": route,
                   "bits_equal": True, "max_abs_err": 0.0}
            if kind == "ties":
                # equal packed winners (score and in-segment index) ascend
                # by candidate position
                n_seg = sub // 128
                idx = (i % sub) // n_seg
                cand = (i // sub) * n_seg + i % n_seg
                tied = (s[:, 1:] == s[:, :-1]) & (idx[:, 1:] == idx[:, :-1])
                assert int(tied.sum()) > 0
                assert bool((cand[:, 1:][tied] > cand[:, :-1][tied]).all())
                res["tied_neighbours"] = int(tied.sum())
            out.append(res)
            del q, c, scale, s, i, s2, i2
    return out


# DeepFM's slots at the Criteo width (64 embedding + 1 linear), B1's lr
# and eps; DCNv2's one slot of 16 (`configs/models/dcnv2.yaml`) and
# xDeepFM's 16 + 1 (`configs/models/xdeepfm.yaml`)
B1_DIMS, B1_LR, B1_EPS = (DIM, 1), 0.05, 1e-8
B1_ZOO_DIMS = (16,)
B1_XDEEPFM_DIMS = (16, 1)


def b1_slots(dims):
    """(accumulator columns, used columns) of a pack row laid out as the
    trainer lays it out: [values of each slot | one g2 a slot | 0 pad]."""
    w = sum(dims)
    return tuple(w + i for i in range(len(dims))), w + len(dims)


def b1_inputs(gen, ids_kind, dims=B1_DIMS, grad_dtype=torch.bfloat16):
    """A (2.6M, 128) pack laid out as the trainer lays out the Criteo
    fields' rows (DeepFM's [64 embedding | 1 linear | 2 accumulators | 0
    pad] by default, DCNv2's [16 | 1 accumulator | 0 pad] with dims (16,)),
    851,968 ids (one per field and example), the gathered rows G and the
    row gradients (bf16 from DeepFM's bf16 model, f32 from DCNv2's)."""
    rows = NUM_CAT * VOCAB
    acc, used = b1_slots(dims)
    w = sum(dims)
    pack = torch.zeros(rows, 128, device=DEVICE)
    pack[:, :w] = 1e-2 * torch.randn(rows, w, generator=gen, device=DEVICE)
    pack[:, w:used] = torch.rand(rows, len(dims), generator=gen,
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
        grad_dtype) for d in dims]
    return pack, ids, G, grads


def b1_call(fn, pack, ids, G, grads, dims=B1_DIMS):
    acc, used = b1_slots(dims)
    return fn(pack, ids, G, grads, B1_LR, dims=dims, acc_cols=acc,
              used=used, eps=B1_EPS)


def b1_agreement(pack, plain, pre, ids, upd):
    """Asserts the kernel's pack against the plain version's after one
    update. Rows hit once: rtol 1e-5, atol 1e-7 (only the mean's sum order
    differs). A row hit c > 1 times sums its c updates in a run-dependent
    order (atomics, and the kernel's sums of a block's rows of one id; the
    plain version's `index_add_` sums with atomics too), so there each
    entry may differ by the rounding of that order, bounded by c * 2^-23 *
    (|pre| + sum of the |updates|) on top."""
    count = torch.bincount(ids.long(), minlength=pack.shape[0])
    touched = count > 0
    once, dup = count == 1, count > 1
    err = (pack - plain).abs()
    assert torch.equal(pack[~touched], plain[~touched])
    torch.testing.assert_close(pack[once], plain[once], rtol=1e-5, atol=1e-7)
    mag = pre.abs().index_add_(0, ids, upd.abs())[dup]
    bound = (count[dup, None].float() * 2.0 ** -23 * mag
             + 1e-5 * plain[dup].abs() + 1e-7)
    assert bool((err[dup] <= bound).all()), float((err[dup] - bound).max())
    return {"n": int(ids.shape[0]), "unique": int(touched.sum()),
            "dup_rows": int(dup.sum()), "max_count": int(count.max()),
            "max_abs_err": float(err.max()),
            "max_abs_err_once": float(err[once].max()) if bool(once.any())
            else 0.0,
            "tolerance": "rows hit once rtol 1e-5 atol 1e-7; a row hit c "
                         "times within c*2^-23*(|pre|+sum|upd|) + 1e-5*|x| "
                         "+ 1e-7"}


def check_b1(gen, ids_kind, dims=B1_DIMS, grad_dtype=torch.bfloat16):
    """B1 against its plain version after one update of the full pack at
    the layout of ``dims`` (`b1_agreement`'s tolerances)."""
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_,
    )
    pack, ids, G, grads = b1_inputs(gen, ids_kind, dims, grad_dtype)
    pre, plain = pack.clone(), pack.clone()
    b1_call(packed_adagrad_update_, pack, ids, G, grads, dims)
    b1_call(packed_adagrad_update_plain_, plain, ids, G, grads, dims)
    torch.cuda.synchronize()
    acc, used = b1_slots(dims)
    upd = fused_adagrad_delta_plain(G, grads, B1_LR, dims=dims,
                                    acc_cols=acc, used=used,
                                    store_w=128, eps=B1_EPS)
    return {"ids": ids_kind, "dims": list(dims), "grads": str(grad_dtype),
            **b1_agreement(pack, plain, pre, ids, upd)}


def b1_update_agreement(pack, plain, pre, ids, upd):
    """Asserts the update the kernel added, pack - pre, against the plain
    version's, plain - pre, entry by entry, relative to the updates
    themselves: within 1e-5 of the sum of the |updates| of the entry's
    row, plus the rounding of the two sums into pre (c + 1 roundings of
    2^-23 (|pre| + sum |upd|) each for a row hit c times, whatever their
    order)."""
    count = torch.bincount(ids.long(), minlength=pack.shape[0])
    touched = count > 0
    mag = torch.zeros_like(pack).index_add_(0, ids, upd.abs())[touched]
    got, want = (pack - pre)[touched], (plain - pre)[touched]
    err = (got - want).abs()
    bound = (1e-5 * mag + (count[touched, None].float() + 1) * 2.0 ** -23
             * (pre[touched].abs() + mag))
    assert bool((err <= bound).all()), float((err - bound).max())
    rel = err / mag.clamp_min(1e-30)
    return {"max_abs_err_update": float(err.max()),
            "max_rel_err_update": float(rel[mag > 0].max()),
            "update_tolerance": "|(pack-pre) - (plain-pre)| <= 1e-5*sum|upd| "
                                "+ (c+1)*2^-23*(|pre|+sum|upd|)"}


# (pack width, slot dims, accumulator columns in G, grad dtype, base offset
# in floats): the Criteo layout, the zoo's (DCNv2's one slot of 16, and
# xDeepFM's 16 + 1, f32 gradients), and with them every instantiation of B1
# (bf16 / f32 gradients x reductions of 4 / 2 / 1 floats), slots whose
# values straddle its chunks, rows wider than its 16 lanes' chunks, a pack
# base aligned to 8 or 4 bytes only
B1_LAYOUTS = ((128, (64, 1), (65, 66), torch.bfloat16, 0),
              (130, (64, 1), (65, 66), torch.float32, 0),
              (130, (64, 1), (65, 66), torch.bfloat16, 0),
              (67, (64, 1), (65, 66), torch.bfloat16, 0),
              (67, (64, 1), (65, 66), torch.float32, 0),
              (16, (3, 5, 1), (15, 9, 13), torch.bfloat16, 0),
              (132, (128, 1), (129, 130), torch.float32, 0),
              (1028, (1000, 8, 3), (1026, 1020, 7), torch.bfloat16, 0),
              (128, (64, 1), (65, 66), torch.bfloat16, 1),
              (128, (64, 1), (65, 66), torch.float32, 2),
              (128, (16,), (16,), torch.float32, 0),
              (128, (16, 1), (17, 18), torch.float32, 0))


def check_b1_layouts(gen, rows=5000, n=20_000):
    """B1 against its plain version at each layout of `B1_LAYOUTS`, over
    uniform and Zipf ids: the packs (`b1_agreement`'s tolerances) and the
    updates themselves (`b1_update_agreement`). Every used column is drawn
    near 0 (1e-6 rand), so the updates stand out of the pack and the g^2
    the kernel adds (~1e-6 for 1e-3 gradients) weighs as much as the
    accumulator in each delta."""
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_, reduction_width,
    )
    rng = np.random.default_rng(SEED)
    out = []
    for width, dims, accs, dtype, offset in B1_LAYOUTS:
        for ids_kind in ("uniform", "zipf"):
            used = sum(dims) + len(dims)
            flat = torch.zeros(rows * width + offset, device=DEVICE)
            pack = flat[offset:].view(rows, width)
            pack[:, :used] = 1e-6 * torch.rand(rows, used, generator=gen,
                                               device=DEVICE)
            local = rng.integers(0, rows, n) if ids_kind == "uniform" \
                else (rng.zipf(1.2, n) - 1) % rows
            ids = torch.from_numpy(local.astype(np.int32)).to(DEVICE)
            G = pack.index_select(0, ids)
            grads = [(1e-3 * torch.randn(n, d, generator=gen,
                                         device=DEVICE)).to(dtype)
                     for d in dims]
            kw = dict(dims=dims, acc_cols=accs, used=used, eps=B1_EPS)
            pre, plain = pack.clone(), pack.clone()
            packed_adagrad_update_(pack, ids, G, grads, B1_LR, **kw)
            packed_adagrad_update_plain_(plain, ids, G, grads, B1_LR, **kw)
            torch.cuda.synchronize()
            upd = fused_adagrad_delta_plain(G, grads, B1_LR, store_w=width,
                                            **kw)
            out.append({"width": width, "dims": list(dims),
                        "grads": str(dtype), "base_offset": offset,
                        "ids": ids_kind,
                        "vec": reduction_width(width, pack.data_ptr()),
                        **b1_agreement(pack, plain, pre, ids, upd),
                        **b1_update_agreement(pack, plain, pre, ids, upd)})
    assert {(o["grads"], o["vec"]) for o in out} == {
        (str(t), v) for t in (torch.float32, torch.bfloat16)
        for v in (4, 2, 1)}, out
    return out


def b1_bound_ms(ids, grads, dims=B1_DIMS):
    """Each input read once, each output written once: ids, the slots'
    accumulators in G, the gradients, and a read-modify-write of the used
    columns of every touched pack row; against ~6 f32 operations an
    element at 67 TFLOP/s."""
    n = ids.shape[0]
    unique = int(torch.unique(ids).numel())
    _, used = b1_slots(dims)
    moved = n * (ids.element_size() + 4 * len(dims)) \
        + sum(g.numel() * g.element_size() for g in grads) \
        + unique * used * 4 * 2
    by_bytes = moved / HBM_BYTES_S * 1e3
    by_ops = 6.0 * n * sum(dims) / PEAK_OPS["f32"] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations", moved


def time_b1(gen, ids_kind, dims=B1_DIMS, grad_dtype=torch.bfloat16):
    """B1, its plain version, the `index_add_` scatter it absorbs and its
    bound at the layout of ``dims``, over ids drawn as `check_b1` draws
    them (uniform per field as `bench.py` draws them, or Zipf-skewed)."""
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_,
    )
    pack, ids, G, grads = b1_inputs(gen, ids_kind, dims, grad_dtype)
    acc, used = b1_slots(dims)
    upd = fused_adagrad_delta_plain(G, grads, B1_LR, dims=dims,
                                    acc_cols=acc, used=used,
                                    store_w=128, eps=B1_EPS)
    ms = cuda_ms(lambda: b1_call(packed_adagrad_update_, pack, ids, G,
                                 grads, dims), reps=20)
    plain_ms = cuda_ms(lambda: b1_call(packed_adagrad_update_plain_, pack,
                                       ids, G, grads, dims), reps=20)
    # the scatter alone that B1 absorbs, given the finished operand
    library_ms = cuda_ms(lambda: pack.index_add_(0, ids, upd), reps=20)
    b_ms, b_by, moved = b1_bound_ms(ids, grads, dims)
    return {"ids": ids_kind, "dims": list(dims), "grads": str(grad_dtype),
            "n": int(ids.shape[0]), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": moved}


# bench.py's SASRec regimes (`bench.py:354-356`, `:425`): V items, L, d, B
SAS_V, SAS_L, SAS_D, SAS_B = 1_000_000, 50, 64, 1024
SAS_V_SMALL = 60_000
# one exp per logit at the special-function units' ~3.9e12/s (H100 SXM,
# FlashAttention-3 paper)
EXP_RATE = 3.9e12


def b2_inputs(gen, b, v, d, u_std=1.0, t_std=0.125):
    """user (b, d) and table (v, d) f32 on the card; logits of std
    ~u_std * t_std * sqrt(d) (about 1 at the 1M shape)."""
    user = u_std * torch.randn(b, d, generator=gen, device=DEVICE)
    table = t_std * torch.randn(v, d, generator=gen, device=DEVICE)
    return user, table


def b2_sweeps_vs_plain(user, table, lse_shift=None):
    """B2's two wrappers (forward, backward) on the card against their
    plain versions on the same bf16 operands. lse: rtol 1e-5 (ex2.approx
    and another summation order); du, dt: 0.5% of max |plain| (p rounds to
    bf16, and the kernel's exp2 of x log2(e) may round a p to the
    neighbouring bf16 value); rows whose lse_eff is +inf (weight 0) exactly
    0 in du; a second call of each on the same inputs gives the same bits.
    With the kernel's plan (clusters of blocks, passes over B)."""
    from recbox_tpu_torch.ops.fused_ce import (
        _device_plan, ce_operands, fused_ce_bwd, fused_ce_bwd_plain,
        fused_ce_lse, fused_ce_lse_plain,
    )
    u, t = ce_operands(user, table)
    d = user.shape[1]
    lse = fused_ce_lse(u, t)
    lse_p = fused_ce_lse_plain(u, t)
    lse_eff = lse_p if lse_shift is None else lse_p + lse_shift
    scale = torch.tensor(1.0 / user.shape[0], device=DEVICE)
    du, dt = fused_ce_bwd(u, t, lse_eff, scale, d)
    du_p, dt_p = fused_ce_bwd_plain(u, t, lse_eff, scale, d)
    lse2 = fused_ce_lse(u, t)
    du2, dt2 = fused_ce_bwd(u, t, lse_eff, scale, d)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(lse, lse2) and torch.equal(du, du2) \
        and torch.equal(dt, dt2), "B2: two calls differ"
    errs = {"plan": list(_device_plan(u.shape[0], t.shape[0], u.shape[1],
                                      u.device)) if u.is_cuda else None,
            "repeats_bit_identical": True,
            "lse": float((lse - lse_p).abs().max())}
    for name, got, want in (("du", du, du_p), ("dt", dt, dt_p)):
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        assert bool(torch.isfinite(got).all()), name
        assert err <= 5e-3 * top, (name, err, top)
        errs[name] = err
        errs[name + "_rel_to_max"] = err / top if top else 0.0
    if lse_shift is not None:
        dead = torch.isinf(lse_shift)
        assert float(du[dead].abs().max()) == 0.0
        errs["zero_rows_exact"] = int(dead.sum())
    return errs


# B2's cluster plans at V = 100,003, D = 64 (B = 200 and 500: clusters of
# one and two blocks; 1500: a second, ragged pass; 8192: eight passes), and
# D = 128 at the 1M shape (clusters of four 128-row blocks, two passes)
B2_PLAN_CASES = ((200, 100_003, 64), (500, 100_003, 64),
                 (1500, 100_003, 64), (8192, 100_003, 64),
                 (SAS_B, SAS_V, 128))


def check_b2(gen):
    """B2 against its plain version on the card: bench.py's 1M shape, a
    ragged shape (B, V, D all unaligned), `B2_PLAN_CASES`, weights with
    zeros, the all-160 and all--40 logit cases, and the multinomial
    variant; every call of the kernel twice, bit for bit."""
    from recbox_tpu_torch.ops.fused_ce import (
        fused_multinomial_ce, fused_softmax_ce,
    )
    out = []
    for b, v, d in ((SAS_B, SAS_V, SAS_D), (1000, 100_003, 100),
                    *B2_PLAN_CASES):
        user, table = b2_inputs(gen, b, v, d, t_std=1.0 / math.sqrt(d))
        out.append({"case": "shape", "b": b, "v": v, "d": d,
                    **b2_sweeps_vs_plain(user, table)})
    # weights with zeros: lse_eff = lse - log w, +inf where w = 0
    user, table = b2_inputs(gen, SAS_B, SAS_V, SAS_D)
    w = torch.rand(SAS_B, generator=gen, device=DEVICE)
    w[::7] = 0.0
    out.append({"case": "weights_with_zeros", "b": SAS_B, "v": SAS_V,
                "d": SAS_D, **b2_sweeps_vs_plain(user, table, -torch.log(w))})
    u = user.clone().requires_grad_(True)
    labels = torch.randint(0, SAS_V, (SAS_B,), generator=gen, device=DEVICE)
    fused_softmax_ce(u, table, labels, w).backward()
    assert float(u.grad[w == 0].abs().max()) == 0.0
    # extreme logits through the whole function: CE = log V exactly
    for case, value, v in (("all_160", 10.0, 256), ("all_minus_40", 2.0, 300),
                           ("all_minus_40_large_v", 2.0, 100_003)):
        tv = 1.0 if value == 10.0 else -1.25
        user = torch.full((8, 16), value, device=DEVICE, requires_grad=True)
        table = torch.full((v, 16), tv, device=DEVICE, requires_grad=True)
        loss = fused_softmax_ce(user, table,
                                torch.arange(8, device=DEVICE))
        loss.backward()
        torch.cuda.synchronize()
        loss = float(loss.detach())
        assert abs(loss - math.log(v)) <= 1e-5 * math.log(v), \
            (case, loss)
        assert bool(torch.isfinite(user.grad).all()
                    & torch.isfinite(table.grad).all()), case
        out.append({"case": case, "v": v, "loss": loss,
                    "log_v": math.log(v)})
    # multinomial: 20 positives a row, an empty row, lse_eff = lse - log n
    b, v, h = 256, 100_000, 20
    user, table = b2_inputs(gen, b, v, SAS_D)
    pos = torch.randint(0, v, (b, h), generator=gen, device=DEVICE)
    mask = (torch.rand(b, h, generator=gen, device=DEVICE) > 0.3).float()
    mask[3] = 0.0
    errs = b2_sweeps_vs_plain(user, table, -torch.log(mask.sum(1)))
    u = user.clone().requires_grad_(True)
    loss = fused_multinomial_ce(u, table, pos, mask)
    loss.backward()
    loss = float(loss.detach())
    assert math.isfinite(loss) and float(u.grad[3].abs().max()) == 0
    out.append({"case": "multinomial", "b": b, "v": v, "h": h, "d": SAS_D,
                "loss": loss, **errs})
    return out


def b2_bounds(b, v, d):
    """(fwd, bwd): the least time in ms, "bytes" or "operations", which
    of the three limits sets it ("bytes", "tensor_cores" or "exps"), the
    bytes and the tensor-core operations: the largest of the bytes (each
    input read once, each output written once: bf16 operands; fwd writes
    lse, bwd f32 du and dt) at the HBM rate, 2BVD operations forward and 3
    products backward at the bf16 peak, and one exp per logit (BV, each
    direction) at `EXP_RATE`; and the exp floor alone."""
    fwd_bytes = (b + v) * d * 2 + b * 4
    bwd_bytes = (b + v) * d * 2 + b * 4 + (b + v) * d * 4
    fwd_ops, bwd_ops = 2.0 * b * v * d, 3 * 2.0 * b * v * d
    exp_ms = b * v / EXP_RATE * 1e3
    out = {}
    for name, nbytes, ops in (("fwd", fwd_bytes, fwd_ops),
                              ("bwd", bwd_bytes, bwd_ops)):
        limits = {"bytes": nbytes / HBM_BYTES_S * 1e3,
                  "tensor_cores": ops / PEAK_OPS["bf16"] * 1e3,
                  "exps": exp_ms}
        what = max(limits, key=limits.get)
        out[name] = (limits[what], "bytes" if what == "bytes"
                     else "operations", what, nbytes, ops)
    return out, exp_ms


B2_DESIGN = {
    "fwd": "clusters over B (up to 4 blocks of 256 rows at D <= 64), a "
           "persistent walk over V with one TMA multicast of each 64-row "
           "table tile into the cluster, four consumer warpgroups on wgmma "
           "(S = U T^T) folding an online max / sum of exp2 in registers; "
           "lse_combine over the clusters",
    "bwd": "one sweep on the forward's skeleton (two consumer warpgroups), "
           "each exp formed once: p in registers feeds du += p T (wgmma, A "
           "from registers, the tile MN-major) and, through shared memory, "
           "dT = p^T U (MN-major A and B); du resident in registers over the "
           "walk, summed over clusters by du_reduce; dT reduced and scattered "
           "over the cluster: each block's share of a tile's partials sent by "
           "bulk copy into that block's slots (distributed shared memory), "
           "summed there in rank order one step later and written once"}


def time_b2(gen):
    """B2 alone at the 1M shape: each wrapper (kernel), its plain version,
    and the materialised PyTorch formulation (a bf16 torch.matmul into 2 GB
    of logits, then F.cross_entropy; the port never calls it), forward and
    forward + backward, CUDA events, median of 10."""
    import torch.nn.functional as F
    from recbox_tpu_torch.ops.fused_ce import (
        ce_operands, fused_ce_bwd, fused_ce_bwd_plain, fused_ce_lse,
        fused_ce_lse_plain,
    )
    user, table = b2_inputs(gen, SAS_B, SAS_V, SAS_D)
    labels = torch.randint(0, SAS_V, (SAS_B,), generator=gen, device=DEVICE)
    u, t = ce_operands(user, table)
    lse = fused_ce_lse(u, t)
    scale = torch.tensor(1.0 / SAS_B, device=DEVICE)
    reps = 10
    res = {
        "fwd_ms": cuda_ms(lambda: fused_ce_lse(u, t), reps),
        "bwd_ms": cuda_ms(lambda: fused_ce_bwd(u, t, lse, scale, SAS_D),
                          reps),
        "fwd_plain_ms": cuda_ms(lambda: fused_ce_lse_plain(u, t), reps),
        "bwd_plain_ms": cuda_ms(
            lambda: fused_ce_bwd_plain(u, t, lse, scale, SAS_D), reps)}
    ul = u.detach().clone().requires_grad_(True)
    tl = t.detach().clone().requires_grad_(True)

    def library_fwd():
        with torch.no_grad():
            return F.cross_entropy(ul @ tl.T, labels)

    def library_fwd_bwd():
        F.cross_entropy(ul @ tl.T, labels).backward()

    res["fwd_library_ms"] = cuda_ms(library_fwd, reps)
    res["fwd_bwd_library_ms"] = cuda_ms(library_fwd_bwd, reps)
    del ul, tl
    bounds, exp_ms = b2_bounds(SAS_B, SAS_V, SAS_D)
    for name in ("fwd", "bwd"):
        b_ms, b_by, what, nbytes, ops = bounds[name]
        res.update({f"{name}_bound_ms": b_ms, f"{name}_bound_by": b_by,
                    f"{name}_bound_what": what, f"{name}_bytes": nbytes,
                    f"{name}_ops": ops})
    res["exp_floor_ms"] = exp_ms
    return res


# the candidate generator's profiling shape (`tools/prof_mips_batched.py:
# 45-47`, query tile `:47`), the merge-only shape of
# `tools/prof_retrieval_topk.py:161-175`, and the sequence pool's
# (`embedding_gather.py:16-22`)
B4_N, B4_D, B4_Q, B4_TILE = 1_000_000, 128, 8192, 1024
B5_MERGE = (7812, 1024)
B5_FULL = 7936        # the candidates of the B4 path at that shape
B6_V, B6_B, B6_L = 1_000_000, 8192, 50
B4_VARIANTS = (("packed", torch.bfloat16, True), ("packed_int8", torch.int8,
                                                   True),
               ("unpacked", torch.bfloat16, False))
# the f32 instantiations, checked at the small shapes only
B4_F32_VARIANTS = (("packed", torch.float32, True),
                   ("unpacked", torch.float32, False))
# a corpus and a few queries whose grid is too small for the card (the
# packed variants split each sub-chunk into runs merged by atomic max), and
# a mid-size one with no split runs; the last 37 rows past valid_items
B4_SMALL = ((3000, 20), (100_000, 1024))
# the plans the wgmma route takes at D=128 (bf16, int8): query tiles of
# 8192, 4096, 2048 and 1024 queries give n_seg = 1, 2, 4 and 8; 300
# queries (a ragged second tile of 256) over a corpus whose last sub-chunk
# is ragged, rows past valid_items
B4_PLAN_TILES = (8192, 4096, 2048, 1024)
B4_PLAN_SHAPE = (50_000, 300)


def b4_inputs(gen, dtype, integer, n=None, nq=None, d=B4_D):
    """Queries (Q, D) and corpus (N, D) on the card as the candidate kernel
    takes them (bf16 or f32; or int8 rows of `quantize_int8` with their
    scales), from small integers or N(0, 1); B4's shape by default."""
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    n, nq = n or B4_N, nq or B4_Q
    if integer:
        q = torch.randint(-4, 5, (nq, d), generator=gen,
                          device=DEVICE).float()
        c = torch.randint(-4, 5, (n, d), generator=gen,
                          device=DEVICE).float()
    else:
        q = torch.randn(nq, d, generator=gen, device=DEVICE)
        c = torch.randn(n, d, generator=gen, device=DEVICE)
    if dtype == torch.int8:
        c8, scale = quantize_int8(c)
        return quantize_int8(q)[0], c8, scale
    return q.to(dtype), c.to(dtype), None


def b4_candidates(q, c, scale, packed, valid=None, tile=None):
    """The kernel at the plan of a tile of ``tile`` (default min(1024, Q))
    queries, as `pallas_mips_topk` launches it, and that plan's sub_rows."""
    from recbox_tpu_torch.ops.mips_topk import _candidates, candidate_plan
    n = c.shape[0]
    tile = tile or min(B4_TILE, q.shape[0])
    sub, n_cand = candidate_plan(c.dtype, n, c.shape[1], tile)
    return _candidates(q, c, n if valid is None else valid, packed, scale,
                       sub, n_cand), sub


def b4_pair(q, c, scale, packed, valid=None, tile=None):
    """The kernel (`b4_candidates`) and its plain version on the same inputs
    over the rows that hold corpus rows (the rest the wrapper fills alike);
    the route the launch took and its split runs (the tile route's)."""
    from recbox_tpu_torch.ops.mips_topk import (
        candidate_route, mips_segment_candidates_plain, route_launches,
        split_runs,
    )
    n, nq = c.shape[0], q.shape[0]
    valid = n if valid is None else valid
    before = dict(route_launches)
    got, sub = b4_candidates(q, c, scale, packed, valid, tile)
    route = candidate_route(c.dtype, c.shape[1], sub)
    assert route_launches[route] == before[route] + 1, (route, before)
    want = mips_segment_candidates_plain(q, c, valid, packed, scale, sub)
    n_live = (want if packed else want[0]).shape[0]
    got = got[:n_live] if packed else (got[0][:n_live], got[1][:n_live])
    splits = 1 if route == "wgmma" else split_runs(nq, n, sub, packed,
                                                   c.device)
    return got, want, {"route": route, "sub_rows": sub, "splits": splits}


def b4_bits_equal(got, want, packed):
    if packed:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) \
        and torch.equal(got[1], want[1])


def check_b4_small(gen):
    """Every instantiation of B4 (f32 too) at the `B4_SMALL` shapes, and
    bf16 packed and unpacked and int8 at each plan of the wgmma route
    (`B4_PLAN_TILES`) at D = 128 and 64, on integer-valued inputs, against
    the plain version bit for bit; at the first small shape the packed ones
    must run split on the tile route, and each plan tile must take the
    wgmma route."""
    out = []
    cases = [(n, nq, None, B4_D, v) for n, nq in B4_SMALL
             for v in B4_VARIANTS + B4_F32_VARIANTS]
    cases += [(*B4_PLAN_SHAPE, tile, d, v) for d in (B4_D, DIM)
              for tile in B4_PLAN_TILES for v in B4_VARIANTS]
    for n, nq, tile, d, (name, dtype, packed) in cases:
        q, c, scale = b4_inputs(gen, dtype, True, n, nq, d)
        got, want, how = b4_pair(q, c, scale, packed, n - 37, tile)
        torch.cuda.synchronize()
        assert b4_bits_equal(got, want, packed), (n, nq, tile, name, dtype)
        if packed and n == B4_SMALL[0][0]:
            assert how["route"] == "tile" and how["splits"] > 1, (n, how)
        if tile is not None:
            assert how["route"] == "wgmma", (tile, how)
        out.append({"variant": name, "dtype": str(dtype), "n": n, "d": d,
                    "q": nq, "plan_tile": tile, "valid_items": n - 37,
                    **how, "bits_equal": True, "max_abs_err": 0.0})
    return out


def check_b4(gen):
    """B4's three variants against the plain version at the profiling
    shape, and at D = 64 (B3's serving depth, also on the wgmma route).
    Integer-valued inputs (and int8, always exact) must agree bit
    for bit. N(0, 1) bf16 sums in another order: the share of candidates
    whose winning row differs (a near-tie) must be <= 1e-3, and where the
    row agrees the score within 3e-5 relative (packed: one 2^-16 packing
    step and the rounding) or 1e-5 (unpacked)."""
    from recbox_tpu_torch.ops.mips_topk import PACK_MASK
    out = []
    cases = [(v, d, i) for d in (B4_D, DIM) for v in B4_VARIANTS
             for i in (True, False)]
    for (name, dtype, packed), d, integer in cases:
        q, c, scale = b4_inputs(gen, dtype, integer, d=d)
        got, want, how = b4_pair(q, c, scale, packed)
        torch.cuda.synchronize()
        assert how["route"] == "wgmma", (name, d, how)
        if packed:
            gb, wb = got.view(torch.int32), want.view(torch.int32)
            g_row, w_row = gb & PACK_MASK, wb & PACK_MASK
            g_s = (gb & ~PACK_MASK).view(torch.float32)
            w_s = (wb & ~PACK_MASK).view(torch.float32)
            bits_equal = torch.equal(gb, wb)
        else:
            (g_s, g_row), (w_s, w_row) = got, want
            bits_equal = torch.equal(g_s.view(torch.int32),
                                     w_s.view(torch.int32)) \
                and torch.equal(g_row, w_row)
        same = g_row == w_row
        mismatch = 1.0 - same.float().mean().item()
        err = (g_s - w_s)[same].abs()
        max_err = err.max().item()
        if integer or dtype == torch.int8:
            assert bits_equal, (name, integer)
            tolerance = "bit for bit"
        else:
            rtol = 3e-5 if packed else 1e-5
            assert mismatch <= 1e-3, (name, mismatch)
            assert bool((err <= rtol * w_s[same].abs() + 1e-6).all()), \
                (name, max_err)
            tolerance = (f"winner differs on <= 1e-3 of candidates; "
                         f"scores rtol {rtol} atol 1e-6 elsewhere")
        out.append({"variant": name, "d": d, "inputs": "integer"
                    if integer else "normal", "route": how["route"],
                    "candidates": list(w_s.shape),
                    "bits_equal": bits_equal,
                    "winner_mismatch_share": mismatch,
                    "max_abs_err": max_err, "tolerance": tolerance})
        del q, c, scale, got, want
    return out


def b5_inputs(gen, c, q, ties=False):
    """Candidate-major (C, Q) scores and distinct int32 ids on the card;
    ``ties`` rounds the scores to bf16 so many are equal."""
    s = torch.randn(c, q, generator=gen, device=DEVICE)
    if ties:
        s = s.to(torch.bfloat16).float()
    ids = torch.randperm(c * q, generator=gen, device=DEVICE).view(c, q)
    return s, ids.to(torch.int32)


# B5's further checks: a windowed shape (C past the kernel's 16384-key
# window: three windows carry the top k), and k = C at one window's width
B5_WINDOWED = (40_000, 64)
B5_FULL_K = (16384, 8)


def check_b5(gen):
    """B5 against its plain version, bit for bit: the merge-only shape at
    k=500 and 100, and the B4 path's (7936, 8192) at k=500 with bf16-rounded
    scores (ties that the total order breaks the same way on both), all
    candidate-major; the merge-only shape row-major through
    `pallas_bitonic_topk` (ids and the default positions); the windowed
    shape at k=500 with ties; k = C. Each at the plan's queries a block."""
    from recbox_tpu_torch.ops.bitonic_topk import (
        bitonic_topk_plain, pallas_bitonic_topk, pallas_bitonic_topk_cmajor,
        select_plan,
    )
    out = []
    cases = ((B5_MERGE, K, False, "cmajor"), (B5_MERGE, 100, False, "cmajor"),
             ((B5_FULL, B4_Q), K, True, "cmajor"),
             (B5_MERGE, K, False, "rows"), (B5_MERGE, K, False, "positions"),
             (B5_WINDOWED, K, True, "cmajor"),
             (B5_FULL_K, B5_FULL_K[0], True, "cmajor"))
    for (c, q), k, ties, layout in cases:
        s, ids = b5_inputs(gen, c, q, ties)
        if layout == "cmajor":
            ts, ti = pallas_bitonic_topk_cmajor(s, ids, k)
            ts, ti = ts.T, ti.T
            ps, pi = bitonic_topk_plain(s.T, ids.T, k)
        else:
            rows = s.T.contiguous()
            row_ids = None if layout == "positions" else ids.T.contiguous()
            ts, ti = pallas_bitonic_topk(rows, row_ids, k)
            ps, pi = bitonic_topk_plain(rows, row_ids, k)
        torch.cuda.synchronize()
        assert ts.shape == (q, k) and ti.shape == (q, k)
        assert torch.equal(ts, ps) and torch.equal(ti, pi), (c, q, k, layout)
        assert bool((ts[:, 1:] <= ts[:, :-1]).all())
        qb, window, kpt, _ = select_plan(c, k)
        out.append({"c": c, "q": q, "k": k, "ties": ties, "layout": layout,
                    "queries_a_block": qb, "keys_a_thread": kpt,
                    "window": window,
                    "windows": -(-c // window), "equal_to_plain": True,
                    "max_abs_err": 0.0})
    return out


def b6_inputs(d, seed=SEED, ids_kind="zipf"):
    """A (V, d) f32 table and (B, L) ids on the card: Zipf(1.2) ids over
    V - 1 rows (~51k distinct, which the 50 MB L2 holds at D=128) or
    uniform ones (~280k distinct, 143 MB at D=128: they reach HBM), ~20% of
    positions and every 97th row all pad_id = V - 1."""
    rng = np.random.default_rng(seed)
    if ids_kind == "zipf":
        ids = (rng.zipf(1.2, (B6_B, B6_L)) - 1) % (B6_V - 1)
    else:
        ids = rng.integers(0, B6_V - 1, (B6_B, B6_L))
    ids[rng.random((B6_B, B6_L)) < 0.2] = B6_V - 1
    ids[::97] = B6_V - 1
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    table = torch.randn(B6_V, d, generator=gen, device=DEVICE)
    return table, torch.from_numpy(ids).to(DEVICE), B6_V - 1


def check_b6():
    """B6 against its plain version at D=128 (mean and sum; Zipf and
    uniform ids) and D=64: each entry within 1e-6 of the pooled |rows|
    (another summation order), rows of pads exactly 0, a second call equal
    bit for bit. Last, ids out of range: -1 reads row V - 1, V and -V - 1
    make their rows NaN, on both."""
    from recbox_tpu_torch.ops.embedding_gather import (
        seq_embedding_pool, seq_embedding_pool_plain,
    )
    out = []
    for d, mode, kind in ((128, "mean", "zipf"), (128, "sum", "zipf"),
                          (DIM, "mean", "zipf"), (128, "mean", "uniform"),
                          (DIM, "mean", "uniform"), (DIM, "mean", "bad")):
        table, ids, pad = b6_inputs(d, ids_kind="uniform" if kind ==
                                    "uniform" else "zipf")
        if kind == "bad":
            ids[5, 3], ids[7, 0], ids[11, 2] = -1, B6_V, -B6_V - 1
        got = seq_embedding_pool(table, ids, pad, mode)
        again = seq_embedding_pool(table, ids, pad, mode)
        want = seq_embedding_pool_plain(table, ids, pad, mode)
        mag = seq_embedding_pool_plain(table.abs(), ids, pad, mode)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), (d, mode, kind)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        assert int(nan.any(1).sum()) == (2 if kind == "bad" else 0)
        err = (got - want).abs()[~nan]
        assert got.dtype == torch.float32 and got.shape == (B6_B, d)
        assert bool((err <= 1e-6 * mag[~nan] + 1e-30).all()), (d, mode)
        assert float(got[::97].abs().max()) == 0.0
        out.append({"d": d, "mode": mode, "ids": kind,
                    "max_abs_err": float(err.max()),
                    "pad_share": float((ids == pad).float().mean()),
                    "repeat_bit_identical": True,
                    "tolerance": "1e-6 of the pooled |rows|; NaN rows alike"})
    return out


def recall_at(ids, exact):
    ids, exact = np.asarray(ids), np.asarray(exact)
    return float(np.mean([len(set(ids[r].tolist()) & set(exact[r].tolist()))
                          / exact.shape[1] for r in range(exact.shape[0])]))


def candidate_paths(gen):
    """Phase 4b, the candidate paths: `pallas_mips_topk` at the profiling
    shape packed (default merge), unpacked with the bitonic merge and with
    the exact merge, and over int8 rows; `seq_embedding_pool` at B6's
    shapes. Counts of B4 (by variant and by route), B5 and B6 reset just
    before, read just after: every call takes B4's wgmma route. Then each
    `pallas_mips_topk` call is timed (ms per 8192
    queries, median of 3, CUDA events) beside its candidate generation
    alone, the difference being its merge."""
    from recbox_tpu_torch.ops import bitonic_topk, embedding_gather, mips_topk
    from recbox_tpu_torch.ops.mips_topk import pallas_mips_topk, quantize_int8
    q = torch.randn(B4_Q, B4_D, generator=gen, device=DEVICE)
    c = torch.randn(B4_N, B4_D, generator=gen, device=DEVICE)
    qb, cb = q.to(torch.bfloat16), c.to(torch.bfloat16)
    c8, scale = quantize_int8(c)
    pools = [b6_inputs(d) for d in (128, DIM)]
    calls = {
        "packed": lambda: pallas_mips_topk(qb, cb, K, query_tile=B4_TILE),
        "bitonic": lambda: pallas_mips_topk(qb, cb, K, packed=False,
                                            merge="bitonic",
                                            query_tile=B4_TILE),
        "exact": lambda: pallas_mips_topk(qb, cb, K, packed=False,
                                          exact_merge=True,
                                          query_tile=B4_TILE),
        "int8": lambda: pallas_mips_topk(q, c8, K, row_scale=scale,
                                         query_tile=B4_TILE)}
    for mod in (mips_topk, bitonic_topk, embedding_gather):
        mod.reset_launches()
    res = {name: call() for name, call in calls.items()}
    pooled = [embedding_gather.seq_embedding_pool(t, i, p, "mean")
              for t, i, p in pools]
    torch.cuda.synchronize()
    counts = {**mips_topk.launches, **bitonic_topk.launches,
              **embedding_gather.launches}
    routes = dict(mips_topk.route_launches)
    assert counts == {"packed": 1, "packed_int8": 1, "unpacked": 2,
                      "bitonic_topk": 1, "seq_embedding_pool": 2}, counts
    # the 1024-query plan of every call on the new route
    assert routes == {"wgmma": 4, "tile": 0}, routes
    for name, (s, i) in res.items():
        assert s.shape == (B4_Q, K) and i.shape == (B4_Q, K), name
        assert bool(torch.isfinite(s).all()), name
        assert bool(((i >= 0) & (i < B4_N)).all()), name
        assert bool((s[:, 1:] <= s[:, :-1]).all()), name
    assert torch.equal(res["bitonic"][1], res["exact"][1])
    assert torch.equal(res["bitonic"][0], res["exact"][0])
    exact = torch.topk(q[:512] @ c.T, K, dim=1).indices.cpu()
    recall = {name: recall_at(i[:512].cpu(), exact)
              for name, (s, i) in res.items()}
    assert min(recall["packed"], recall["bitonic"]) >= 0.95, recall
    assert recall["int8"] >= 0.90, recall
    for out, (t, _, _) in zip(pooled, pools):
        assert out.shape == (B6_B, t.shape[1])
        assert bool(torch.isfinite(out).all())
    del res, pooled
    c8q = quantize_int8(q)[0]
    gens = {"packed": lambda: b4_candidates(qb, cb, None, True),
            "bitonic": lambda: b4_candidates(qb, cb, None, False),
            "int8": lambda: b4_candidates(c8q, c8, scale, True)}
    gens["exact"] = gens["bitonic"]
    per = B4_Q / 8192
    times = {}
    for name, call in calls.items():
        path_ms = cuda_ms(call, reps=3) / per
        cand_ms = cuda_ms(gens[name], reps=3) / per
        times[name] = {"path_ms": path_ms, "candidates_ms": cand_ms,
                       "merge_ms": path_ms - cand_ms,
                       "merge_share": (path_ms - cand_ms) / path_ms}
    return counts, {"routes": routes, "k": K, "queries": 512,
                    "recall": recall, "bitonic_equals_exact_merge": True,
                    "predicted": 1 - K * 128 / (2 * B4_N),
                    "ms_per_8192_queries": times}


def service_paths(model, item_embs, users):
    """Phase 4b, the rest of `BruteForceMIPS` behind `RetrievalService` on
    phase 4's corpus: 'refined' (bf16 over-retrieval, exact f32 rescore),
    int8 'approx' and int8 'refined', against an exact f32 oracle over 512
    users; refined scores equal the f32 dot products of their ids."""
    from recbox_tpu_torch.retrieval import RetrievalService
    svcs = {"refined": RetrievalService(model, item_embs=item_embs,
                                        method="refined"),
            "int8_approx": RetrievalService(model, item_embs=item_embs,
                                            method="approx", quantize="int8"),
            "int8_refined": RetrievalService(model, item_embs=item_embs,
                                             method="refined",
                                             quantize="int8")}
    sub = {k: v[:512] for k, v in users.items()}
    with torch.no_grad():
        u = svcs["refined"]._encode(model.encode_user, sub)
        exact = torch.topk(u @ item_embs.T, K, dim=1).indices.cpu()
    out = {}
    for name, svc in svcs.items():
        s, i = svc.query(users, k=K)
        assert s.shape == (N_QUERIES, K) and np.isfinite(s).all()
        assert (i >= 0).all() and (i < N_ITEMS).all()
        rec = recall_at(i[:512], exact)
        out[name] = {"recall": rec}
        if name.endswith("refined"):
            assert rec >= 0.99, (name, rec)
            with torch.no_grad():
                true = torch.einsum(
                    "qd,qkd->qk", u.double(),
                    item_embs.double()[torch.from_numpy(i[:512]).long()
                                       .to(item_embs.device)]).cpu().numpy()
            np.testing.assert_allclose(s[:512], true, rtol=1e-5, atol=1e-6)
        else:
            assert rec >= 0.90, (name, rec)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            svc.query(users, k=K)
            walls.append(time.perf_counter() - t0)
        out[name]["qps"] = N_QUERIES / statistics.median(walls)
    return out


def b4_library(q, c_pad, scale_pad, sub, packed):
    """One PyTorch formulation of B4's function: per 1024-query chunk, the
    cuBLAS product (bf16 torch.matmul, or torch._int_mm and the row scale),
    then the strided segment amax (and argmax unpacked) over a corpus
    padded to whole sub-chunks; no packing."""
    n_seg = sub // 128
    out = []
    for s0 in range(0, q.shape[0], B4_TILE):
        qc = q[s0:s0 + B4_TILE]
        if c_pad.dtype == torch.int8:
            s = torch._int_mm(qc, c_pad.T).float() * scale_pad
        else:
            s = qc @ c_pad.T
        seg = s.view(qc.shape[0], -1, 128, n_seg)
        out.append(torch.amax(seg, dim=2) if packed else seg.max(dim=2))
    return out


def b4_bound(dtype, packed, d=B4_D):
    """Corpus, queries (and int8 row scales) read once, the candidates
    written once, against 2QND operations at the type's peak."""
    from recbox_tpu_torch.ops.mips_topk import candidate_plan
    size = torch.empty((), dtype=dtype).element_size()
    _, n_cand = candidate_plan(dtype, B4_N, d, B4_TILE)
    moved = (B4_N + B4_Q) * d * size + n_cand * B4_Q * 4 * (
        1 if packed else 2) + (B4_N * 4 if dtype == torch.int8 else 0)
    by_ops = 2.0 * B4_Q * B4_N * d / PEAK_OPS[
        "int8" if dtype == torch.int8 else "bf16"] * 1e3
    by_bytes = moved / HBM_BYTES_S * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes \
        else "bytes"


def b4_tile_route(q, c, scale, packed, sub):
    """B4's tile route (its first design) forced through the library's C
    entry on inputs the wrapper sends to the wgmma route, for a same-run
    comparison; the port's wrapper never does this."""
    from recbox_tpu_torch.ops import mips_topk as m
    nq, (n, d) = q.shape[0], c.shape
    rows = -(-n // sub) * (sub // 128)
    out_s = torch.empty((rows, nq), device=c.device)
    out_i = None if packed else torch.empty((rows, nq), dtype=torch.int32,
                                            device=c.device)
    splits = m.split_runs(nq, n, sub, packed, c.device)
    if splits > 1:
        out_s.fill_(float("-inf"))
    rc = m._kernel_lib().recbox_mips_segment_candidates(
        m._DTYPES[c.dtype], int(packed), q.data_ptr(), c.data_ptr(),
        None if scale is None else scale.data_ptr(), out_s.data_ptr(),
        None if out_i is None else out_i.data_ptr(), nq, n, d, n, sub,
        splits, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out_s, out_i


def time_b4(gen):
    """Each B4 variant at the profiling shape and at D = 64: kernel (on the
    route the wrapper picks), plain version, the library formulation, the
    bound, and the tile route on the same inputs. Keyed (variant, D)."""
    import torch.nn.functional as F
    from recbox_tpu_torch.ops.mips_topk import (
        candidate_plan, candidate_route, mips_segment_candidates_plain,
    )
    out = {}
    for (name, dtype, packed), d in ((v, d) for d in (B4_D, DIM)
                                     for v in B4_VARIANTS):
        q, c, scale = b4_inputs(gen, dtype, False, d=d)
        sub, _ = candidate_plan(dtype, B4_N, d, B4_TILE)
        route = candidate_route(dtype, d, sub)
        pad = (-B4_N) % sub
        c_pad = F.pad(c, (0, 0, 0, pad))
        scale_pad = None if scale is None else F.pad(scale, (0, pad))
        ms = cuda_ms(lambda: b4_candidates(q, c, scale, packed))
        tile_ms = cuda_ms(lambda: b4_tile_route(q, c, scale, packed, sub)) \
            if route == "wgmma" else ms
        plain_ms = cuda_ms(lambda: mips_segment_candidates_plain(
            q, c, B4_N, packed, scale, sub), reps=3)
        library_ms = cuda_ms(lambda: b4_library(q, c_pad, scale_pad, sub,
                                                packed), reps=3)
        b_ms, b_by = b4_bound(dtype, packed, d)
        out[name, d] = {"variant": name, "route": route, "n": B4_N, "d": d,
                     "q": B4_Q, "query_tile": B4_TILE, "ms": ms,
                     "tile_route_ms": tile_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        del q, c, scale, c_pad, scale_pad
    return out


def time_b5(gen):
    """B5 on the B4 path's (7936, 8192) candidates at k=500 and the
    merge-only shape at k=500 / 100: kernel, plain version and torch.topk
    on the (Q, C) view, the kernel and torch.topk over runs of 20 calls
    behind a spin kernel; the byte bound; the compare-exchanges of the
    survivors' sort."""
    from recbox_tpu_torch.ops.bitonic_topk import (
        bitonic_topk_plain, pallas_bitonic_topk_cmajor, select_plan,
    )
    out = []
    for (c, q), k in (((B5_FULL, B4_Q), K), (B5_MERGE, K), (B5_MERGE, 100)):
        s, ids = b5_inputs(gen, c, q)
        qb, _, kpt, p = select_plan(c, k)
        width = max(p, 512)   # the kernel's register sort takes 512 keys
        stages = int(math.log2(width)) * (int(math.log2(width)) + 1) // 2
        # every score read once; ids only of the k winners; k pairs written
        moved = c * q * 4 + k * q * 4 + k * q * 8
        out.append({
            "c": c, "q": q, "k": k, "queries_a_block": qb,
            "keys_a_thread": kpt,
            "ms": cuda_ms(lambda: pallas_bitonic_topk_cmajor(s, ids, k),
                          reps=11, inner=20),
            "plain_ms": cuda_ms(lambda: bitonic_topk_plain(s.T, ids.T, k)),
            "library_ms": cuda_ms(lambda: torch.topk(s.T, k, dim=1),
                                  reps=11, inner=20),
            "bound_ms": moved / HBM_BYTES_S * 1e3, "bound_by": "bytes",
            "bytes": moved,
            "sort_compare_exchanges": stages * (width // 2) * q})
    return out


def b6_bound(table, ids, pad):
    """Each distinct non-pad row read once, the ids read once, the output
    written once; one add an element is far below the f32 peak."""
    rows = torch.unique(ids[ids != pad]).numel()
    d = table.shape[1]
    moved = rows * d * 4 + ids.numel() * 4 + ids.shape[0] * d * 4
    return moved / HBM_BYTES_S * 1e3, moved, rows


def time_b6():
    """B6 at D=128 and 64 over Zipf ids (their rows stay in the 50 MB L2
    across the timed run) and uniform ones (they reach HBM): kernel (with
    the wrapper's cast of the int64 ids, and on int32 ids), plain version,
    F.embedding_bag, the bound."""
    import torch.nn.functional as F
    from recbox_tpu_torch.ops.embedding_gather import (
        seq_embedding_pool, seq_embedding_pool_plain,
    )
    out = []
    for kind, d in (("zipf", 128), ("zipf", DIM), ("uniform", 128),
                    ("uniform", DIM)):
        table, ids, pad = b6_inputs(d, ids_kind=kind)
        ids32 = ids.to(torch.int32)
        b_ms, moved, rows = b6_bound(table, ids, pad)
        out.append({
            "d": d, "v": B6_V, "b": B6_B, "l": B6_L, "mode": "mean",
            "ids": kind, "distinct_rows_mb": rows * d * 4 / 1e6,
            "ms": cuda_ms(lambda: seq_embedding_pool(table, ids, pad),
                          reps=11, inner=20),
            # the kernel alone: the wrapper casts int64 ids to int32 first
            "ms_int32_ids": cuda_ms(lambda: seq_embedding_pool(
                table, ids32, pad), reps=11, inner=20),
            "plain_ms": cuda_ms(lambda: seq_embedding_pool_plain(
                table, ids, pad)),
            "library_ms": cuda_ms(lambda: F.embedding_bag(
                ids, table, mode="mean", padding_idx=pad), reps=11, inner=20),
            "bound_ms": b_ms, "bound_by": "bytes", "bytes": moved,
            "distinct_rows": rows,
            "bound_ms_every_position": (
                int((ids != pad).sum()) * d * 4 + ids.numel() * 4
                + B6_B * d * 4) / HBM_BYTES_S * 1e3})
    return out


def sasrec_setup(vocab, train_method, seed=SEED):
    """bench.py's SASRec regime (`bench.py:426-441`): 2 layers, 2 heads,
    L = 50, d = 64, dropout 0.1, bf16 compute, Adam 1e-3 with clip 10;
    the batch drawn as `bench.py:434-438` draws it."""
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.sequential import SASRec
    from recbox_tpu_torch.ops.losses import full_softmax_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    fm = FeatureMap("sasbench", (FeatureSpec(
        "item_id", "categorical", vocab_size=vocab,
        embedding_dim=SAS_D),), corpus_index="item_id", num_items=vocab)
    model = SASRec(fm, embedding_dim=SAS_D, max_seq_len=SAS_L, n_layers=2,
                   n_heads=2, dropout=0.1, compute_dtype="bfloat16",
                   generator=torch.Generator(device=DEVICE).manual_seed(seed),
                   device=DEVICE)
    loss = (lambda o, b: o) if train_method == "fused_ce_loss" else \
        (lambda o, b: full_softmax_loss(o, b["item_id"]))
    trainer = Trainer(model, loss, TrainerConfig(learning_rate=1e-3,
                                                 grad_clip_norm=10.0,
                                                 seed=seed),
                      device=DEVICE, train_method=train_method)
    rng = np.random.default_rng(seed)
    batch = {
        "item_seq": rng.integers(1, vocab, (SAS_B, SAS_L)).astype(np.int32),
        "seq_len": np.full(SAS_B, SAS_L, np.int32),
        "item_id": rng.integers(1, vocab, SAS_B).astype(np.int32),
    }
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    return trainer, batch


def timed_repeat_steps(trainer, batch):
    """WARMUP_STEPS steps, then TIMED_STEPS one by one through
    `train_steps_repeat`, CUDA events around each; (losses, step ms)."""
    losses = [trainer.train_steps_repeat(batch, WARMUP_STEPS)]
    events = []
    for _ in range(TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_steps_repeat(batch, 1))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return ([float(x) for x in torch.cat(losses)],
            [s.elapsed_time(e) for s, e in events])


def train_sasrec_1m():
    """The sequential training path at bench.py's 1M-item shape through
    kernel B2: its counts reset just before the 15 steps, read just after."""
    from recbox_tpu_torch.ops import fused_ce
    trainer, batch = sasrec_setup(SAS_V, "fused_ce_loss")
    t0 = time.perf_counter()
    trainer.init(batch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fused_ce.reset_launches()
    losses, step_ms = timed_repeat_steps(trainer, batch)
    launches = dict(fused_ce.launches)
    n = WARMUP_STEPS + TIMED_STEPS
    assert launches == {"fused_ce_fwd": n, "fused_ce_bwd": n}, launches
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    med = statistics.median(step_ms)
    return trainer, batch, {
        "vocab": SAS_V, "batch": SAS_B, "seq_len": SAS_L, "dim": SAS_D,
        "init_s": init_s, "losses": losses, "launches": launches,
        "step_ms": step_ms, "median_step_ms": med,
        "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
        "examples_per_s": SAS_B / med * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def sasrec_markov_on_card():
    """The CPU learning test's model and data (`tests/test_torch_sequential
    .py`), trained on the card through kernel B2: hit@1 > 0.8."""
    from recbox_tpu_torch.data import ArrayLoader
    from recbox_tpu_torch.data.sequential import leave_one_out_split
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.sequential import SASRec
    from recbox_tpu_torch.ops import fused_ce
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    rng = np.random.default_rng(3)
    n_items, seqs = 40, {}
    for u in range(200):
        start = rng.integers(1, n_items + 1)
        seqs[u] = np.array([(start + k - 1) % n_items + 1
                            for k in range(12)])
    train, valid, _ = leave_one_out_split(seqs, max_len=8)
    fm = FeatureMap("seq", (FeatureSpec(
        "item_id", "categorical", source="item", vocab_size=n_items + 1,
        embedding_dim=32),), query_index="user_id", corpus_index="item_id",
        num_items=n_items + 1)
    model = SASRec(fm, embedding_dim=32, max_seq_len=8, n_layers=1,
                   n_heads=2, dropout=0.0, compute_dtype="bfloat16",
                   generator=torch.Generator(device=DEVICE).manual_seed(0),
                   device=DEVICE)
    trainer = Trainer(model, lambda out, b: out,
                      TrainerConfig(learning_rate=5e-3), device=DEVICE,
                      train_method="fused_ce_loss")
    before = fused_ce.launches["fused_ce_bwd"]
    loader = ArrayLoader(train, batch_size=256, drop_last=True, seed=0)
    for _ in range(6):
        for batch in loader:
            batch.pop("__mask__", None)
            trainer.train_step(batch)
    model.eval()
    with torch.no_grad():
        scores = model.full_scores(
            {k: torch.from_numpy(valid[k]).to(DEVICE)
             for k in ("item_seq", "seq_len")})
    hit = float(np.mean(scores.argmax(-1).cpu().numpy() == valid["item_id"]))
    steps = fused_ce.launches["fused_ce_bwd"] - before
    assert steps == 6 * len(loader), steps
    assert hit > 0.8, hit
    return {"hit_at_1": hit, "b2_backward_launches": steps}


def sasrec_60k_comparison():
    """`_bench_sasrec`'s 60k-item regime (`bench.py:339-404`): the same
    model and batch trained through `full_scores` (bf16 logits in memory,
    cuBLAS, full_softmax_loss) and through `fused_ce_loss` (B2), in turns
    (full, fused, fused, full), 12 timed steps each."""
    out = {"full_scores": [], "fused_ce_loss": []}
    for method in ("full_scores", "fused_ce_loss", "fused_ce_loss",
                   "full_scores"):
        trainer, batch = sasrec_setup(SAS_V_SMALL, method)
        trainer.init(batch)
        losses, step_ms = timed_repeat_steps(trainer, batch)
        assert all(np.isfinite(losses)), (method, losses)
        out[method].append(statistics.median(step_ms))
        del trainer, batch
    return {"vocab": SAS_V_SMALL,
            **{f"{m}_median_step_ms": v for m, v in out.items()},
            **{f"{m}_examples_per_s": SAS_B / statistics.mean(v) * 1e3
               for m, v in out.items()}}


def sasrec_breakdown(trainer, batch, steps=None):
    """Device time by kernel group of one steady SASRec 1M step
    (torch.profiler): B2 forward and backward, GEMMs, the rest; the device
    spans of the trainer's phases (Adam over the 1M x 64 table among them);
    the device's idle share of the step's wall time."""
    return train_breakdown(trainer, batch, (
        ("b2_forward", ("ce_fwd", "lse_combine")),
        ("b2_backward", ("ce_bwd", "du_reduce")),
        ("gemm", ("gemm", "nvjet", "sm90", "cutlass", "xmma", "splitk")),
        ("copies_casts", ("copy", "cast", "fill")),
        ("embedding_gather_scatter", ("index", "embedding", "gather",
                                      "scatter")),
    ), steps=steps or (lambda: trainer.train_steps_repeat(batch, 1)))


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


CRITEO_GROUPS = (
    ("b1_packed_adagrad_update", ("packed_adagrad_update",)),
    ("gemm", ("gemm", "nvjet", "sm90", "cutlass", "xmma", "splitk")),
    ("gather_index_select", ("gather", "indexselect", "index_select")),
)


def train_breakdown(trainer, batch, groups=CRITEO_GROUPS, steps=None):
    """Device time by kernel of one steady train step (torch.profiler),
    summed into ``groups`` ((name, substrings of a lower-case kernel name),
    first match wins, the rest "other"); the device timeline's span of each
    of the trainer's phases (gather, forward, backward, Adam, row update);
    and the device's idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    step = steps or (lambda: trainer.train_step(batch))
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
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
    sums = {name: 0.0 for name, _ in groups}
    sums["other"] = 0.0
    for name, ms, _ in rows:
        low = name.lower().replace("_", "")
        hit = next((g for g, keys in groups
                    if any(k.replace("_", "") in low for k in keys)),
                   "other")
        sums[hit] += ms
    if device_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "groups": None, "phase_span_ms": None, "by_kernel": []}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms, "groups": sums,
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


# -- 5c-5e: training to a result ---------------------------------------------

FIT_TRAIN_BATCHES, FIT_HELD_OUT_BATCHES, FIT_K, FIT_BLOCKS = 24, 4, 8, 6
SAS_FIT_BATCHES, SAS_EVAL_USERS = 16, 4096
EXIT_SEEDS = (2024, 1, 2, 3, 4)


def clone_state(obj):
    """A deep copy of a trainer's `state_dict` (its tensors are the live
    ones)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: clone_state(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [clone_state(v) for v in obj]
    return obj


def stacked(batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def fused_vs_eager(trainer, batches, launches):
    """Ms a step of the same batches through eager `train_step` and through
    `train_steps_fused`: FIT_BLOCKS blocks of FIT_K steps a side, in turns
    (eager then fused, fused then eager, ...), the chunks of ``batches``
    taken in a round, each block by the host clock to a synchronize. The
    kernel's launches counted over the fused calls (one a step)."""
    fused_counts = {k: 0 for k in launches}

    def eager(chunk, _):
        for b in chunk:
            trainer.train_step(b)

    def fused(_, stack):
        before = dict(launches)
        trainer.train_steps_fused(stack)
        for k in fused_counts:
            fused_counts[k] += launches[k] - before[k]

    chunks = [batches[i:i + FIT_K]
              for i in range(0, len(batches) - FIT_K + 1, FIT_K)]
    stacks = [stacked(c) for c in chunks]
    blocks = {"eager": [], "fused": []}
    torch.cuda.synchronize()
    for i in range(FIT_BLOCKS):
        arg = (chunks[i % len(chunks)], stacks[i % len(chunks)])
        order = (("eager", eager), ("fused", fused))
        for name, call in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            call(*arg)
            torch.cuda.synchronize()
            blocks[name].append((time.perf_counter() - t0) * 1e3 / FIT_K)
    n_fused = FIT_K * FIT_BLOCKS
    bsz = len(next(iter(batches[0].values())))
    med = {name: statistics.median(v) for name, v in blocks.items()}
    out = {"blocks_a_side": FIT_BLOCKS, "block_steps": FIT_K,
           "fused_steps": n_fused, "fused_launches": fused_counts,
           "per_step_launches": {k: v / n_fused
                                 for k, v in fused_counts.items()},
           "eager_over_fused": med["eager"] / med["fused"],
           "eager_over_fused_range": [min(blocks["eager"])
                                      / max(blocks["fused"]),
                                      max(blocks["eager"])
                                      / min(blocks["fused"])]}
    for name, v in blocks.items():
        out.update({f"{name}_block_ms_per_step": v,
                    f"{name}_median_ms": med[name],
                    f"{name}_min_ms": min(v), f"{name}_max_ms": max(v),
                    f"{name}_examples_per_s": bsz / med[name] * 1e3})
    return out


def graph_step_matches_eager(trainer, batch, tensors):
    """One replayed step and one eager step from the same state on the same
    batch, with the same dropout draws (the trainer's generator set back
    between them): the losses agree within 1e-5 of the loss, and each of
    ``tensors()`` (name -> live tensor) moves by the same update (within
    1e-3 of the update's largest entry: B1's atomics add duplicates in no
    fixed order). An lr baked into the graph at another value would move
    them by another factor; a replay that skipped a kernel, another loss."""
    # detached copies: a copy that kept a parameter's autograd node alive
    # would tie the capture to the stream that made it
    snap = clone_state(trainer.state_dict())
    gen = trainer.dropout_generator
    draws = gen.get_state() if gen is not None else None
    before = {k: v.detach().clone() for k, v in tensors().items()}
    loss_graph = float(trainer.train_steps_fused(stacked([batch]))[0])
    graph = {k: v.detach().clone() for k, v in tensors().items()}
    trainer.load_state_dict(snap)
    if gen is not None:
        gen.set_state(draws)
    loss_eager = float(trainer.train_step(batch))
    assert abs(loss_graph - loss_eager) <= 1e-5 * abs(loss_eager), \
        (loss_graph, loss_eager)
    out = {"loss": {"graph": loss_graph, "eager": loss_eager}}
    for k, v in tensors().items():
        upd = (v - before[k]).abs().max().item()
        err = (graph[k] - v).abs().max().item()
        assert upd > 0 and err <= 1e-3 * upd, (k, err, upd)
        out[k] = {"max_update": upd, "max_abs_diff": err}
    trainer.load_state_dict(snap)
    return out


def fit_criteo():
    """Phase 5c: `fit` of phase 5's trainer over 24 batches for 2 epochs,
    FIT_K steps a `train_steps_fused` call, `CTREvaluator` on 4 held-out
    batches; a plateau forced at the second evaluation (the monitored
    value is 1 at the first and 0 at the second), then the replayed step
    held to an eager one at the decayed lr; save / load into a fresh
    trainer, `predict` bit for bit; eager against fused examples/s."""
    import tempfile
    from recbox_tpu_torch.evaluation import CTREvaluator
    from recbox_tpu_torch.ops import packed_delta

    from recbox_tpu_torch.training import Monitor

    trainer = criteo_trainer(SEED)
    cfg = trainer.config
    cfg.epochs, cfg.fused_steps, cfg.lr_decay_factor = 2, FIT_K, 0.1
    trainer.monitor = Monitor("forced", "max", patience=2)
    data = CriteoBatches(SEED + 2)
    batches = [data() for _ in range(FIT_TRAIN_BATCHES)]
    held = [data() for _ in range(FIT_HELD_OUT_BATCHES)]
    held_np = {k: torch.cat([b[k] for b in held]).cpu().numpy()
               for k in held[0]}
    ctr = CTREvaluator(held_np, label="click", metrics=["AUC", "logloss"],
                       batch_size=BATCH)
    evals = []

    def eval_fn(tr):
        t0 = time.perf_counter()
        metrics = ctr(tr)
        evals.append({"epoch": tr.epoch, "lr": tr.learning_rate,
                      "emb_lr": tr._emb_lr, "eval_s":
                      time.perf_counter() - t0, **metrics})
        return {**metrics, "forced": 1.0 if len(evals) == 1 else 0.0}

    trainer.eval_fn = eval_fn
    trainer.init(batches[0])
    lr0, emb0 = trainer.learning_rate, trainer._resolve_emb_lr()
    packed_delta.reset_launches()
    t0 = time.perf_counter()
    trainer.fit(list(batches))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = packed_delta.launches["packed_adagrad_update"]
    steps = cfg.epochs * FIT_TRAIN_BATCHES
    assert trainer.step == steps and launches == steps, (trainer.step,
                                                         launches)
    assert len(evals) == 2 and trainer.monitor.best_epoch == 0, evals
    # the label is a logistic rule of the ids of c0..c3, learnt by the best
    # (first) epoch, whose weights the plateau reloads
    assert evals[0]["AUC"] > 0.5, evals
    lr1, emb1 = trainer.learning_rate, trainer._emb_lr
    assert math.isclose(lr1, lr0 * 0.1, rel_tol=1e-6) \
        and math.isclose(emb1, emb0 * 0.1, rel_tol=1e-6), (lr1, emb1)
    capture_s = trainer._graph.capture_seconds
    # the next fused step captures again, at the decayed embedding lr
    (pname,) = trainer.packs
    match = graph_step_matches_eager(
        trainer, batches[0],
        lambda: {"pack": trainer.packs[pname],
                 "dnn_w1": trainer.params["dnn_w1"]})
    assert trainer._graph.token == emb1, (trainer._graph.token, emb1)
    t0 = time.perf_counter()
    trainer._capture_best()
    torch.cuda.synchronize()
    best_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        trainer.save(path)
        save_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(path)
        fresh = criteo_trainer(SEED + 7)
        fresh.init(batches[0])
        t0 = time.perf_counter()
        fresh.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    probe = {k: v for k, v in held[0].items() if k != "click"}
    same = np.array_equal(trainer.predict([dict(probe)]),
                          fresh.predict([dict(probe)]))
    assert same and fresh.step == trainer.step \
        and fresh._emb_lr == trainer._emb_lr
    del fresh
    speed = fused_vs_eager(trainer, batches, packed_delta.launches)
    assert speed["fused_launches"]["packed_adagrad_update"] \
        == speed["fused_steps"], speed
    return trainer, batches[0], {
        "fit_s": fit_s, "steps": steps, "fused_steps": cfg.fused_steps,
        "b1_launches": launches, "evals": evals,
        "lr": [lr0, lr1], "emb_lr": [emb0, emb1],
        "replay_vs_eager_after_plateau": match,
        "capture_s": capture_s, "recapture_s": trainer._graph.capture_seconds,
        "capture_best_s": best_s, "checkpoint_bytes": ckpt_bytes,
        "save_s": save_s, "load_s": load_s, "predict_bit_equal": same,
        **speed}


def sasrec_batches(n, seed):
    """``n`` batches drawn as `bench.py:434-438` draws one, on the card."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"item_seq": rng.integers(1, SAS_V, (SAS_B, SAS_L)),
             "seq_len": np.full(SAS_B, SAS_L),
             "item_id": rng.integers(1, SAS_V, SAS_B)}
        out.append({k: torch.from_numpy(v.astype(np.int32)).to(DEVICE)
                    for k, v in b.items()})
    return out


def fit_sasrec_1m():
    """Phase 5d: `fit` of phase 5b's trainer over 16 batches for 2 epochs,
    FIT_K steps a fused call, evaluated each epoch by `evaluate_retrieval`
    (4096 held-out users, full sort over the 1M items through the chunk
    clamp); two replays draw different dropout masks; a replayed step
    equals an eager one with the same draws (loss, the 1M x 64 table, an
    encoder weight); B2 launches once each way a step; eager against
    fused examples/s."""
    from recbox_tpu_torch.evaluation import evaluate_retrieval
    from recbox_tpu_torch.nn.core import Dropout
    from recbox_tpu_torch.ops import fused_ce
    from recbox_tpu_torch.training import Monitor

    trainer, _ = sasrec_setup(SAS_V, "fused_ce_loss")
    cfg = trainer.config
    cfg.epochs, cfg.fused_steps = 2, FIT_K
    trainer.monitor = Monitor("NDCG(k=10)", "max", patience=2)
    batches = sasrec_batches(SAS_FIT_BATCHES, SEED + 3)
    held = sasrec_batches(SAS_EVAL_USERS // SAS_B, SEED + 4)
    held = {k: torch.cat([b[k] for b in held]) for k in held[0]}
    targets = held["item_id"].cpu().numpy()
    evals = []

    def eval_fn(tr):
        t0 = time.perf_counter()
        users = tr.apply({"item_seq": held["item_seq"],
                          "seq_len": held["seq_len"]}, method="user_tower")
        metrics = evaluate_retrieval(
            users, tr.model.emb_item.detach(), {},
            {u: [int(t)] for u, t in enumerate(targets)},
            range(SAS_EVAL_USERS), ["Recall(k=10)", "NDCG(k=10)"],
            chunk_size=4096, exclude_items=(0,), device=DEVICE)
        torch.cuda.synchronize()
        evals.append({"epoch": tr.epoch, "eval_s":
                      time.perf_counter() - t0, **metrics})
        return metrics

    trainer.eval_fn = eval_fn
    drop = next(m for m in trainer.model.modules() if isinstance(m, Dropout))
    seen = []

    def keep_output(module, inputs, output):
        if module.training:
            seen[:] = [output.detach()]

    hook = drop.register_forward_hook(keep_output)
    trainer.init(batches[0])
    fused_ce.reset_launches()
    t0 = time.perf_counter()
    trainer.fit(list(batches))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(fused_ce.launches)
    steps = cfg.epochs * SAS_FIT_BATCHES
    assert launches == {"fused_ce_fwd": steps, "fused_ce_bwd": steps}, \
        launches
    assert len(evals) == 2 and all(np.isfinite(e["NDCG(k=10)"])
                                   for e in evals), evals
    # the hooked output is the captured step's, rewritten by each replay
    masks = []
    for b in batches[:2]:
        trainer.train_steps_fused(stacked([b]))
        torch.cuda.synchronize()
        masks.append(seen[0] != 0)
    hook.remove()
    drop_rate = [1 - float(m.float().mean()) for m in masks]
    differ = float((masks[0] != masks[1]).float().mean())
    assert all(0.08 < r < 0.12 for r in drop_rate) and differ > 0.1, \
        (drop_rate, differ)
    # after the masks: the check's eager step replaces the hooked tensor
    params = trainer.params
    match = graph_step_matches_eager(
        trainer, batches[0],
        lambda: {k: params[k] for k in ("emb_item",
                                        "sasrec.encoder.q0.weight")})
    speed = fused_vs_eager(trainer, batches, fused_ce.launches)
    n = speed["fused_steps"]
    assert speed["fused_launches"] == {"fused_ce_fwd": n,
                                       "fused_ce_bwd": n}, speed
    return trainer, batches[0], {
        "fit_s": fit_s, "steps": steps, "b2_launches": launches,
        "evals": evals, "eval_users": SAS_EVAL_USERS,
        "replay_vs_eager": match,
        "eval_chunk": (1 << 28) // SAS_V,
        "dropout_drop_rate": drop_rate, "dropout_masks_differ": differ,
        "capture_s": trainer._graph.capture_seconds, **speed}


def quality_exits_on_card():
    """Phase 5e: `tools/quality_exit.py`'s DeepFM synthctr and SASRec
    synthseq runs, and the DCNv2 ('stacked') / xDeepFM (CIN relu) synthctr
    runs, on the card, seeds EXIT_SEEDS; valid and test metrics a seed and
    the medians of the test metrics. Then SASRec's first seed
    again through the 1M-item trainer's path (`fused`: kernel B2's loss,
    8-step `train_steps_fused` graphs), one B2 forward and backward a step,
    its test metrics within 0.02 (the exit's SASRec limit) of the median
    of the `full_scores` runs."""
    import tempfile
    from recbox_tpu_torch.ops import fused_ce
    from recbox_tpu_torch.tools import quality_exit as qe
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("deepfm", "sasrec", "dcnv2", "xdeepfm"):
            gen, run = qe.RUNS[name]
            data_dir = gen(tmp)
            runs = []
            for seed in EXIT_SEEDS:
                t0 = time.perf_counter()
                res = run(data_dir, seed, DEVICE)
                res["seconds"] = time.perf_counter() - t0
                assert all(np.isfinite(v) for v in res["test"].values()), res
                runs.append({"seed": seed, **res})
            out[name] = {"runs": runs, "median_test": {
                k: statistics.median(r["test"][k] for r in runs)
                for k in runs[0]["test"]}}
        fused_ce.reset_launches()
        t0 = time.perf_counter()
        res = qe.run_sasrec(qe.gen_seq(tmp), EXIT_SEEDS[0], DEVICE,
                            fused=True)
        res["seconds"] = time.perf_counter() - t0
    res["b2_launches"] = dict(fused_ce.launches)
    assert res["b2_launches"] == {"fused_ce_fwd": res["steps"],
                                  "fused_ce_bwd": res["steps"]}, res
    median = out["sasrec"]["median_test"]
    assert all(abs(res["test"][k] - median[k]) < 0.02 for k in median), \
        (res, median)
    out["sasrec_fused"] = {"seed": EXIT_SEEDS[0], **res}
    return out


# -- 5f-5g: matching, from training to serving ----------------------------------

# bench.py's LightGCN regime (`bench.py:471-538`): 30,000 users x 41,000
# items, 1M interactions, d = 64, 3 hops, BPR over one negative, batch 2048
LG_USERS, LG_ITEMS, LG_INTER, LG_DIM, LG_HOPS, LG_BATCH = \
    30_000, 41_000, 1_000_000, 64, 3, 2048
LG_BLOCKS, LG_OWN, LG_HELD = 64, 0.9, 0.1
LG_EPOCHS, LG_EVAL_USERS, LG_K, LG_TIMED_BATCHES = 2, 4096, 20, 16
# held-out Recall@20 after training, as a multiple of chance (20 / 41,000)
LG_CHANCE_FACTOR = 10.0
LG_GROUPS = (
    ("index_add", ("indexfunc", "index_add", "indexadd")),
    ("gather_index_select", ("indexselect", "index_select", "gather")),
    ("adam_foreach", ("multitensor", "multi_tensor", "foreach")),
    ("gemm", ("gemm", "nvjet", "sm90", "cutlass", "xmma", "splitk")),
)


def lightgcn_data(seed=SEED):
    """LG_INTER distinct (user, item) pairs with a planted structure: users
    and items in LG_BLOCKS blocks (the items' blocks a random permutation
    of the ids, so a block's items lie scattered over the corpus as a
    catalog's ids would), a pair's item from its user's block with
    probability LG_OWN, else uniform.
    LG_HELD of each user's pairs (rounded down) are held out. Returns
    (train users, train items, held-out user -> items, train user ->
    items)."""
    rng = np.random.default_rng(seed)
    ub = rng.integers(0, LG_BLOCKS, LG_USERS)
    # block b's items: members[b, :] (ids in a random order)
    members = rng.permutation(LG_ITEMS)[:LG_ITEMS // LG_BLOCKS * LG_BLOCKS] \
        .reshape(LG_ITEMS // LG_BLOCKS, LG_BLOCKS).T
    extra = 1.05
    while True:     # draw until LG_INTER distinct pairs, keep the first
        n = int(LG_INTER * extra)
        u = rng.integers(0, LG_USERS, n)
        own = members[ub[u], rng.integers(0, LG_ITEMS // LG_BLOCKS, n)]
        items = np.where(rng.random(n) < LG_OWN, own,
                         rng.integers(0, LG_ITEMS, n))
        _, first = np.unique(u * LG_ITEMS + items, return_index=True)
        if len(first) >= LG_INTER:
            break
        extra += 0.25
    keep = np.sort(first)[:LG_INTER]
    u, items = u[keep], items[keep]
    # rank of each pair inside its user, in a random order
    order = np.lexsort((rng.random(LG_INTER), u))
    us = u[order]
    starts = np.flatnonzero(np.r_[True, us[1:] != us[:-1]])
    counts = np.diff(np.r_[starts, LG_INTER])
    rank = np.arange(LG_INTER) - np.repeat(starts, counts)
    held = np.zeros(LG_INTER, bool)
    held[order] = rank < np.floor(LG_HELD * np.repeat(counts, counts))

    def u2i(sel):
        out = {}
        for a, b in zip(u[sel].tolist(), items[sel].tolist()):
            out.setdefault(a, []).append(b)
        return out

    return (u[~held].astype(np.int32), items[~held].astype(np.int32),
            u2i(held), u2i(~held))


def lightgcn_trainer(train_users, train_items, seed=SEED):
    """Trainer(LightGCN) at bench.py's width over the train edges."""
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.matching import LightGCN, build_norm_edges
    from recbox_tpu_torch.ops.losses import get_matching_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    fm = FeatureMap("lgcn", (
        FeatureSpec("user_id", "categorical", "user", vocab_size=LG_USERS,
                    embedding_dim=LG_DIM),
        FeatureSpec("item_id", "categorical", "item", vocab_size=LG_ITEMS,
                    embedding_dim=LG_DIM)),
        query_index="user_id", corpus_index="item_id", num_items=LG_ITEMS)
    eu, ei, c = build_norm_edges(train_users, train_items, LG_USERS,
                                 LG_ITEMS)
    model = LightGCN(fm, embedding_dim=LG_DIM, num_users=LG_USERS,
                     num_items=LG_ITEMS, n_layers=LG_HOPS, edge_users=eu,
                     edge_items=ei, edge_coefs=c,
                     generator=torch.Generator(device=DEVICE).manual_seed(
                         seed), device=DEVICE)
    bpr = get_matching_loss("PairwiseLogisticLoss")
    cfg = TrainerConfig(learning_rate=1e-3, epochs=LG_EPOCHS,
                        fused_steps=FIT_K, patience=LG_EPOCHS + 1,
                        monitor="Recall(k=20)", lr_decay_factor=1.0,
                        reload_best_on_plateau=False, seed=seed)
    return fm, Trainer(model, lambda o, b: bpr(o), cfg, device=DEVICE), \
        len(eu)


def fit_lightgcn():
    """Phase 5f: LightGCN from training to serving at bench.py's width:
    `MatchingLoader` (one uniform negative, drawn anew each epoch), `fit`
    for LG_EPOCHS epochs in FIT_K-step `train_steps_fused` calls, a full
    sort `RetrievalEvaluator` over LG_EVAL_USERS held-out users each epoch,
    then once with protocol 'uni100'; eager against replayed ms a step; one
    replayed step profiled; then `RetrievalService.from_trainer` over the
    trained towers, bf16 and int8, queried for N_QUERIES users at k = 20,
    B3's and B4's counts reset just before and read just after each
    query."""
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.evaluation import RetrievalEvaluator
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops import mips_topk
    from recbox_tpu_torch.retrieval import RetrievalService
    from recbox_tpu_torch.training.graph import kernel_counters

    t0 = time.perf_counter()
    tr_u, tr_i, held, train_u2i = lightgcn_data()
    fm, trainer, n_edges = lightgcn_trainer(tr_u, tr_i)
    data_s = time.perf_counter() - t0
    corpus = {"item_id": np.arange(LG_ITEMS, dtype=np.int32)}
    loader = MatchingLoader(fm, {"user_id": tr_u, "item_id": tr_i}, corpus,
                            batch_size=LG_BATCH, num_negs=1,
                            exclude_seen=False, seed=SEED)
    eval_users = np.array(sorted(held)[:LG_EVAL_USERS], np.int32)
    metrics = ["Recall(k=20)", "NDCG(k=20)"]
    full = RetrievalEvaluator({"user_id": eval_users}, corpus, eval_users,
                              train_u2i, held, metrics=metrics)
    evals = []

    def eval_fn(tr):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = full(tr)
        torch.cuda.synchronize()
        evals.append({"epoch": tr.epoch, "step": tr.step,
                      "eval_s": time.perf_counter() - t, **out})
        return out

    trainer.eval_fn = eval_fn
    epoch_s = []

    class Timed:
        """The loader, the seconds of each epoch (its sampling pass, the
        steps and the evaluation) recorded."""

        def __iter__(self):
            t = time.perf_counter()
            yield from loader
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t)

        def __getattr__(self, name):
            return getattr(loader, name)

    # the loader's sampling pass and batch assembly alone, one epoch
    t = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    host_epoch_s = time.perf_counter() - t
    # the training step and the evaluators launch none of the port's
    # kernels: LightGCN's hops are index_select / index_add_
    kernel_counts = [dict(c) for c in kernel_counters()]
    t = time.perf_counter()
    trainer.fit(Timed())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    assert [dict(c) for c in kernel_counters()] == kernel_counts
    steps, fit_steps = LG_EPOCHS * n_batches, trainer.step
    chance = LG_K / LG_ITEMS
    recall = [e["Recall(k=20)"] for e in evals]
    t = time.perf_counter()
    uni = RetrievalEvaluator({"user_id": eval_users}, corpus, eval_users,
                             train_u2i, held, metrics=metrics,
                             protocol="uni100")(trainer)
    torch.cuda.synchronize()
    uni_s = time.perf_counter() - t

    # eager against replayed steps, then one replayed step profiled
    batches = []
    for b in loader:
        batches.append({k: torch.from_numpy(v).to(DEVICE)
                        for k, v in b.items()})
        if len(batches) == LG_TIMED_BATCHES:
            break
    speed = fused_vs_eager(trainer, batches, {})
    profiled = train_breakdown(
        trainer, batches[0], LG_GROUPS,
        steps=lambda: trainer.train_steps_fused(stacked([batches[0]])))

    # one forward propagation (3 hops, both sides): what every encode
    # batch of the evaluators and of the service pays again
    with torch.no_grad():
        trainer.model.eval()
        propagate_ms = cuda_ms(trainer.model.propagated) \
            if DEVICE == "cuda" else None
    # serving from the trained towers through B3
    rng = np.random.default_rng(SEED + 5)
    users = {"user_id": rng.integers(0, LG_USERS, N_QUERIES)
             .astype(np.int32)}
    t = time.perf_counter()
    svc = RetrievalService.from_trainer(trainer, corpus)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t
    svc8 = RetrievalService(trainer.model, item_embs=svc.item_embs,
                            method="auto", quantize="int8",
                            device=svc.device)
    serve = {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        s.query(users, k=LG_K)                   # warm
        counts = []
        for _ in range(3):
            fused.reset_launches()
            mips_topk.reset_launches()
            scores, ids = s.query(users, k=LG_K)
            counts.append({"select": sum(fused.launches.values()),
                           **mips_topk.route_launches})
        assert scores.shape == ids.shape == (N_QUERIES, LG_K)
        assert np.isfinite(scores).all() and (ids >= 0).all() \
            and (ids < LG_ITEMS).all()
        assert (np.diff(scores, axis=1) <= 0).all()
        walls = []
        for _ in range(5):
            t = time.perf_counter()
            s.query(users, k=LG_K)
            walls.append(time.perf_counter() - t)
        serve[name] = {"launches_a_query": counts,
                       "recall_vs_exact": recall_vs_bf16_oracle(
                           s, users, ids, k=LG_K),
                       "queries_per_s": N_QUERIES / statistics.median(walls),
                       "query_wall_ms": [w * 1e3 for w in walls]}
    res = {
        "users": LG_USERS, "items": LG_ITEMS, "interactions": LG_INTER,
        "train_edges": n_edges, "held_out": sum(map(len, held.values())),
        "dim": LG_DIM, "hops": LG_HOPS, "batch": LG_BATCH,
        "batches_an_epoch": n_batches, "steps": steps,
        "data_and_model_s": data_s, "loader_epoch_host_s": host_epoch_s,
        "fit_s": fit_s, "epoch_s": epoch_s, "evals": evals,
        "chance_recall": chance,
        "recall_over_chance": [r / chance for r in recall],
        "uni100": uni, "uni100_eval_s": uni_s,
        "capture_s": trainer._graph.capture_seconds,
        "step_speed": speed, "replayed_step_profile": profiled,
        "propagate_ms": propagate_ms, "corpus_encode_s": encode_s,
        "serve": serve}
    # the measurements first, then B3 alone at this shape, then the checks
    emit({"phase": "fit_lightgcn_measured", **res})
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    res["b3_check"] = {v: check_kernel(v, LG_ITEMS, LG_DIM, N_QUERIES, LG_K,
                                       gen) for v in ("bf16", "int8")}
    res["b3_at_this_shape"] = {v: time_kernel(v, LG_ITEMS, LG_DIM,
                                              N_QUERIES, LG_K, gen)
                               for v in ("bf16", "int8")}
    assert fit_steps == steps and len(evals) == LG_EPOCHS, \
        (fit_steps, steps, evals)
    assert all(np.isfinite(list(e.values())).all() for e in evals)
    assert recall[-1] > LG_CHANCE_FACTOR * chance, (recall, chance)
    assert uni["Recall(k=20)"] > recall[-1], (uni, recall)
    for name, v in serve.items():
        assert all(c["select"] == 1 and c["wgmma"] == 1 and c["tile"] == 0
                   for c in v["launches_a_query"]), (name, v)
    assert serve["bf16"]["recall_vs_exact"] >= 0.95 \
        and serve["int8"]["recall_vs_exact"] >= 0.90, serve
    return res


def sparse_mf_graph_check():
    """`SparseEmbeddingTrainer(MF)` on the card over the synth exit's data
    (MatchingLoader batches of 256, one negative): 16 eager `train_step`s
    against two 8-step `train_steps_fused` calls (the first warms up and
    captures the step, the second only replays it) from the same initial
    weights on the same batches; the losses within 1e-5 of the loss, the
    tables and accumulators within 1e-3 of their largest total update
    (`index_add_` adds repeated ids with atomics, in no fixed order).
    Then `RetrievalService.from_trainer` serves the live tables."""
    import tempfile
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.models.matching import MF
    from recbox_tpu_torch.ops.losses import get_matching_loss
    from recbox_tpu_torch.retrieval import RetrievalService
    from recbox_tpu_torch.tools import quality_exit as qe
    from recbox_tpu_torch.training import (
        SparseEmbeddingTrainer, TrainerConfig,
    )
    with tempfile.TemporaryDirectory() as tmp:
        (_, fm, arrays, corpus, *_rest) = qe.matching_setup(
            qe.gen_synth(tmp), EXIT_SEEDS[0])
    loader = MatchingLoader(fm, arrays, corpus, batch_size=256, num_negs=1,
                            seed=SEED)
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
               for b in list(loader)[:2 * FIT_K]]
    assert len(batches) == 2 * FIT_K
    bpr = get_matching_loss("PairwiseLogisticLoss")
    trainers = []
    for _ in range(2):
        model = MF(fm, embedding_dim=32, device=DEVICE,
                   generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        trainers.append(SparseEmbeddingTrainer(
            model, lambda o, b: bpr(o),
            TrainerConfig(learning_rate=5e-2, embedding_regularizer=1e-4),
            device=DEVICE))
    eager, fused = trainers
    eager.init(batches[0])
    fused.init(batches[0])
    start = {k: t.detach().clone() for k, t in eager.tables.items()}
    le = torch.stack([eager.train_step(b) for b in batches])
    lf = torch.cat([fused.train_steps_fused(stacked(batches[i:i + FIT_K]))
                    for i in (0, FIT_K)])
    torch.cuda.synchronize()
    loss_err = float((le - lf).abs().max() / le.abs().max())
    assert loss_err <= 1e-5, (le, lf)
    out = {"steps": len(batches), "loss_rel_err": loss_err,
           "capture_s": fused._graph.capture_seconds}
    for k in eager.tables:
        live, other = eager.tables[k].detach(), fused.tables[k].detach()
        upd = float((live - start[k]).abs().max())
        err = float((live - other).abs().max())
        acc_err = float((eager.accumulators[k] - fused.accumulators[k])
                        .abs().max() / eager.accumulators[k].abs().max())
        assert upd > 0 and err <= 1e-3 * upd and acc_err <= 1e-3, \
            (k, err, upd, acc_err)
        out[k] = {"max_update": upd, "max_abs_diff": err,
                  "acc_rel_diff": acc_err}
    svc = RetrievalService.from_trainer(fused, corpus)
    assert svc.model.item_embedding.tables["item_id"] is \
        fused.tables["item_embedding/emb_item_id"]
    s, i = svc.query({"user_id": np.arange(64, dtype=np.int32)}, k=20)
    assert np.isfinite(s).all() and i.shape == (64, 20)
    return out


def matching_exits_on_card():
    """Phase 5g: the sparse trainer's graph check, then
    `tools/quality_exit.py`'s MF-BPR and LightGCN runs on synth at seeds
    EXIT_SEEDS and MF-BPR on ml1m_scale at the first seed, on the card:
    valid and test metrics a seed, and the medians."""
    import tempfile
    from recbox_tpu_torch.tools import quality_exit as qe
    out = {"sparse_trainer_graph": sparse_mf_graph_check()}
    with tempfile.TemporaryDirectory() as tmp:
        runs = [("bpr", qe.gen_synth, EXIT_SEEDS),
                ("lightgcn", qe.gen_synth, EXIT_SEEDS),
                ("bpr_ml1m_scale", qe.gen_ml1m_scale, EXIT_SEEDS[:1])]
        for name, gen, seeds in runs:
            data_dir = gen(tmp)
            run = qe.run_lightgcn if name == "lightgcn" else qe.run_bpr
            res = []
            for seed in seeds:
                t0 = time.perf_counter()
                r = run(data_dir, seed, DEVICE)
                r["seconds"] = time.perf_counter() - t0
                assert all(np.isfinite(v) for v in r["test"].values()), r
                res.append({"seed": seed, **r})
            out[name] = {"runs": res, "median_test": {
                k: statistics.median(r["test"][k] for r in res)
                for k in res[0]["test"]}}
    return out


# -- 5h-5i: the cascade's ranking and reranking stages -------------------------

# the CTR zoo at the Criteo width: `configs/models/dcnv2.yaml` and
# `configs/models/xdeepfm.yaml` (dim 16, f32), over phase 5's 26 + 13 fields
ZOO_DIM = 16
ZOO_MODELS = {"DCNv2": dict(num_cross_layers=3, hidden_units=(400, 400),
                            dropout=0.0, model_structure="parallel",
                            use_low_rank_mixture=False),
              "xDeepFM": dict(cin_layer_sizes=(16, 16),
                              hidden_units=(400, 400), dropout=0.0)}
ZOO_XDEEPFM_STEPS = 16
ZOO_GROUPS = (
    ("b1_packed_adagrad_update", ("packed_adagrad_update",)),
    ("gemm", ("gemm", "nvjet", "sm90", "cutlass", "xmma", "splitk")),
    ("gather_index_select", ("gather", "indexselect", "index_select")),
    ("copies", ("copy", "catarray", "memcpy", "memset")),
    ("elementwise", ("elementwise", "reduce")),
)


def zoo_feature_map():
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    feats = tuple(
        FeatureSpec(f"c{i}", "categorical", vocab_size=VOCAB,
                    embedding_dim=ZOO_DIM) for i in range(NUM_CAT)) + tuple(
        FeatureSpec(f"n{i}", "numeric", embedding_dim=ZOO_DIM)
        for i in range(NUM_NUM))
    return FeatureMap("criteo_zoo", feats, labels=("click",))


def zoo_trainer(name, seed):
    """PackedEmbeddingTrainer over ``name`` at its config's widths: BCE,
    Adam 1e-3 with clip 10, AdaGrad on the packs, 8 steps a fused call."""
    from recbox_tpu_torch.models import ranking
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import (
        PackedEmbeddingTrainer, TrainerConfig,
    )
    model = getattr(ranking, name)(
        zoo_feature_map(), embedding_dim=ZOO_DIM, **ZOO_MODELS[name],
        generator=torch.Generator(device=DEVICE).manual_seed(seed),
        device=DEVICE)
    cfg = TrainerConfig(learning_rate=1e-3, grad_clip_norm=10.0, epochs=1,
                        seed=seed, fused_steps=FIT_K)
    return PackedEmbeddingTrainer(
        model, lambda o, b: binary_crossentropy(o, b["click"]), cfg,
        device=DEVICE)


def zoo_criteo():
    """Phase 5h: the CTR zoo through B1 at the Criteo width.

    `run_ranking_experiment(model: DCNv2, trainer: packed)` over phase 5's
    arrays (24 batches of 32768, 1 epoch, 8 steps a fused call, the
    logistic label of `CriteoBatches`), `CTREvaluator` on 4 held-out
    batches (AUC above 0.5), B1's count reset just before and read just
    after (one launch a step). Then the same trainer alone: eager against
    replayed ms a step (`fused_vs_eager`), a replayed step equal to an
    eager one (the pack and a cross weight), one replayed step under
    torch.profiler (device time by group, idle share). Then B1 at DCNv2's
    one-slot layout against its plain version, its bound and
    `index_add_`; then xDeepFM at its config's widths: 16 steps in two
    fused calls, falling loss, one B1 launch a step, ms a replayed step,
    and B1 at xDeepFM's 16 + 1 layout (f32 gradients) checked against its
    plain version at the full shape and timed."""
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.quick_start import run_ranking_experiment

    data = CriteoBatches(SEED + 3)
    batches = [data() for _ in range(FIT_TRAIN_BATCHES)]
    held = [data() for _ in range(FIT_HELD_OUT_BATCHES)]

    def arrays(bs):
        return {k: torch.cat([b[k] for b in bs]).cpu().numpy()
                for k in bs[0]}

    config = {"model": "DCNv2", "embedding_dim": ZOO_DIM,
              **ZOO_MODELS["DCNv2"], "trainer": "packed",
              "batch_size": BATCH, "epochs": 1, "fused_steps": FIT_K,
              "learning_rate": 1e-3, "grad_clip_norm": 10.0, "seed": SEED,
              "monitor": "AUC", "metrics": ["AUC", "logloss"]}
    packed_delta.reset_launches()
    t0 = time.perf_counter()
    result = run_ranking_experiment(config, zoo_feature_map(),
                                    arrays(batches), arrays(held),
                                    device=DEVICE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = packed_delta.launches["packed_adagrad_update"]
    assert launches == FIT_TRAIN_BATCHES, launches
    assert result["AUC"] > 0.5 and np.isfinite(result["logloss"]), result
    out = {"run_ranking_experiment": {
        "model": "DCNv2", "steps": FIT_TRAIN_BATCHES, "fit_s": fit_s,
        "b1_launches": launches, **result}}

    trainer = zoo_trainer("DCNv2", SEED)
    trainer.init(batches[0])
    (pname, pack), = trainer.packs.items()
    slots = trainer._slots[pname]
    assert tuple(pack.shape) == (NUM_CAT * VOCAB, 128) \
        and [s.dim for s in slots] == list(B1_ZOO_DIMS), (pname, slots)
    speed = fused_vs_eager(trainer, batches, packed_delta.launches)
    assert speed["fused_launches"]["packed_adagrad_update"] \
        == speed["fused_steps"], speed
    match = graph_step_matches_eager(
        trainer, batches[0],
        lambda: {"pack": trainer.packs[pname],
                 "cross_dense0": trainer.params["CrossNetV2_0.dense0.weight"]})
    profile = train_breakdown(
        trainer, batches[0], groups=ZOO_GROUPS,
        steps=lambda: trainer.train_steps_fused(stacked([batches[0]])))
    out["dcnv2"] = {"pack": pname, "pack_shape": list(pack.shape),
                    "slots": [s.dim for s in slots],
                    "replay_vs_eager": match, "replayed_step_profile":
                    profile, **speed}
    del trainer
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    out["b1_one_slot_check"] = check_b1(gen, "uniform", B1_ZOO_DIMS,
                                        torch.float32)
    out["b1_one_slot_time"] = time_b1(gen, "uniform", B1_ZOO_DIMS,
                                      torch.float32)

    trainer = zoo_trainer("xDeepFM", SEED)
    trainer.init(batches[0])
    (xname, xpack), = trainer.packs.items()
    xslots = trainer._slots[xname]
    # the layout `check_b1` holds below: [16 values | 1 | 2 accumulators]
    assert tuple(xpack.shape) == (NUM_CAT * VOCAB, 128) \
        and [s.dim for s in xslots] == list(B1_XDEEPFM_DIMS) \
        and tuple(s.acc_col for s in xslots) \
        == b1_slots(B1_XDEEPFM_DIMS)[0], (xname, xpack.shape)
    packed_delta.reset_launches()
    losses = torch.cat([
        trainer.train_steps_fused(stacked(batches[i:i + FIT_K]))
        for i in range(0, ZOO_XDEEPFM_STEPS, FIT_K)]).float().cpu().numpy()
    xl = packed_delta.launches["packed_adagrad_update"]
    assert xl == ZOO_XDEEPFM_STEPS and np.isfinite(losses).all(), (xl, losses)
    assert losses[-4:].mean() < losses[:4].mean(), losses
    walls = []
    for i in range(3):
        chunk = stacked(batches[FIT_K * i:FIT_K * (i + 1)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_steps_fused(chunk)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / FIT_K)
    out["xdeepfm"] = {"pack": xname, "steps": ZOO_XDEEPFM_STEPS,
                      "b1_launches": xl, "losses": losses.tolist(),
                      "replayed_ms_per_step": walls,
                      "median_replayed_ms": statistics.median(walls)}
    del trainer, xpack
    out["b1_xdeepfm_check"] = check_b1(gen, "uniform", B1_XDEEPFM_DIMS,
                                       torch.float32)
    out["b1_xdeepfm_time"] = time_b1(gen, "uniform", B1_XDEEPFM_DIMS,
                                     torch.float32)
    return out


# the JAX package's `run_cascade_experiment` at the same knobs and seed,
# on a CPU (PERF.md §7), and the exit's limits for each metric
JAX_CASCADE = {"stage1_test_Recall(k=20)": 0.4922590445209023,
               "stage1_test_NDCG(k=20)": 0.4966593053956695,
               "candidate_recall": 0.8897261534734825,
               "stage2_AUC": 0.884200632340689,
               "stage3_NDCG@10": 0.6312478709377872,
               "stage3_MAP@10": 0.7100689910652758}
CASCADE_LIMITS = {"stage1_test_Recall(k=20)": 0.01,
                  "stage1_test_NDCG(k=20)": 0.01, "candidate_recall": 0.01,
                  "stage2_AUC": 0.01, "stage3_NDCG@10": 0.02,
                  "stage3_MAP@10": 0.02}


def cascade_on_card():
    """Phase 5i: `run_cascade_experiment("ml1m_scale", matcher="MF",
    ranker="DCN", reranker="PRM")` over `quality_exit.gen_ml1m_scale`'s
    files (6040 x 3706, 834,915 interactions) at
    `tools/cascade_ml1m_scale.py`'s knobs (`quality_exit.CASCADE_KNOBS`),
    seed 2024: every metric, the seconds of each stage, and the checks
    that each stage learns what it owns (stage 1 above chance, the ranker's
    AUC above 0.5, the reranker's lists no worse than the ranker's); the
    differences from JAX's run (`JAX_CASCADE`) are reported beside the
    exit's limits, not asserted: a miss is a finding for PERF.md §7."""
    import tempfile
    from recbox_tpu_torch.tools import quality_exit as qe
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data_dir = qe.gen_ml1m_scale(tmp)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = qe.run_cascade(data_dir, EXIT_SEEDS[0], DEVICE)
        wall_s = time.perf_counter() - t0
    r = res["test"]
    assert all(np.isfinite(v) for v in r.values()), r
    vs_jax = {k: r[k] - v for k, v in JAX_CASCADE.items()}
    # chance Recall@20 over 3706 items is ~0.005
    assert r["stage1_test_Recall(k=20)"] > 0.1, r
    assert r["candidate_recall"] > r["stage1_test_Recall(k=20)"], r
    assert r["stage2_AUC"] > 0.5, r
    assert r["stage3_NDCG@10"] >= r["list_ranker_NDCG@10"] - 0.02, r
    return {"seed": EXIT_SEEDS[0], "knobs": {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in qe.CASCADE_KNOBS.items()},
        "gen_s": gen_s, "wall_s": wall_s, "stage_s": res["timings"],
        "metrics": r, "minus_jax": vs_jax, "within_exit_limits": {
            k: abs(d) <= CASCADE_LIMITS[k] for k, d in vs_jax.items()}}


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
    # the redesigned kernels spill nothing: B4's wgmma route at D = 64 and
    # 128 (B3's stage (a) its packed instantiations), B5's selection, B3's
    # selection with its epilogue, B2 both ways, B1 and B6
    redesigned = {"mips_topk": usage_of(_build.build_logs, "mips_topk",
                                        "segment_candidates_wgmma"),
                  "bitonic_topk": usage_of(_build.build_logs, "bitonic_topk",
                                           "select_topk"),
                  "mips_fused_topk": usage_of(_build.build_logs,
                                              "mips_fused_topk",
                                              "select_topk"),
                  "fused_ce": usage_of(_build.build_logs, "fused_ce",
                                       "ce_fwd")
                  + usage_of(_build.build_logs, "fused_ce", "ce_bwd"),
                  "packed_delta": usage_of(_build.build_logs, "packed_delta",
                                           "packed_adagrad_update"),
                  "embedding_gather": usage_of(_build.build_logs,
                                               "embedding_gather",
                                               "seq_pool")}
    for name, usage in redesigned.items():
        emit({"phase": "ptxas_redesigned", "kernel": name, "usage": usage})
        assert usage and all(u["spill_stores"] == u["spill_loads"] == 0
                             for u in usage), (name, usage)
    # B1: bf16 / f32 gradients x reductions of 4 / 2 / 1 floats
    assert len(redesigned["packed_delta"]) == 6, redesigned["packed_delta"]
    # 3 variants x 4 plans at each depth (the depth is the last template
    # argument: ...ELi64EE / ...ELi128EE)
    for depth in (64, 128):
        found = [u for u in redesigned["mips_topk"]
                 if f"ELi{depth}EE" in u["function"]]
        assert len(found) == 12, (depth, len(found))
    # B2: ce_fwd and ce_bwd at depth 64 and 128
    assert len(redesigned["fused_ce"]) == 4, redesigned["fused_ce"]
    b3_ptxas = {"stage_a": [u for u in redesigned["mips_topk"]
                            if "Lb1E" in u["function"]],
                "stage_b": redesigned["mips_fused_topk"]}

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
    b3_integer = check_b3_integer(gen)
    for res in b3_integer:
        emit({"phase": "b3_integer_vs_plain", **res})
    b1_checks = {}
    for ids_kind in ("uniform", "zipf"):
        b1_checks[ids_kind] = check_b1(gen, ids_kind)
        emit({"phase": "b1_vs_plain", **b1_checks[ids_kind]})
    for res in check_b1_layouts(gen):
        emit({"phase": "b1_layouts_vs_plain", **res})
    emit({"phase": "b1_check_launches",
          "launches": packed_delta.launches["packed_adagrad_update"]})
    b2_checks = check_b2(gen)
    for res in b2_checks:
        emit({"phase": "b2_vs_plain", **res})
    # 3c. the candidate kernels and the sequence pool against plain
    b4_checks = check_b4(gen)
    for res in b4_checks + check_b4_small(gen):
        emit({"phase": "b4_vs_plain", **res})
    b5_checks = check_b5(gen)
    for res in b5_checks:
        emit({"phase": "b5_vs_plain", **res})
    b6_checks = check_b6()
    for res in b6_checks:
        emit({"phase": "b6_vs_plain", **res})

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
    results, stages = {}, {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        before = b3_counts()
        for _ in range(3):
            scores, ids = s.query(users, k=K)
        results[name] = (scores, ids)
        stages[name] = {key: n - before[key]
                        for key, n in b3_counts().items()}
    launches = dict(fused.launches)
    emit({"phase": "serve", "launches": launches, "stage_launches": stages,
          "corpus_encode_s": encode_s})
    assert launches["bf16"] >= 3 and launches["int8"] >= 3, launches
    # each query: stage (a) on the wgmma route and the selection, once each
    for name, counts in stages.items():
        assert counts["wgmma"] >= 3 and counts["select"] >= 3 \
            and counts["tile"] == 0, (name, counts)
    recall = {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        scores, ids = results[name]
        assert scores.shape == (N_QUERIES, K) and ids.shape == (N_QUERIES, K)
        assert np.isfinite(scores).all() and (ids >= 0).all() \
            and (ids < N_ITEMS).all()
        assert (np.diff(scores, axis=1) <= 0).all()
        recall[name] = recall_vs_bf16_oracle(s, users, ids)
    # results of successive queries are arrays of their own (each copy
    # goes to a pinned buffer made for its call)
    again = svc.query(users, k=K)
    assert not any(np.shares_memory(a, b) for a in results["bf16"]
                   for b in again)
    assert np.array_equal(again[1], results["bf16"][1])
    del again
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

    # 4b. the candidate paths and the rest of BruteForceMIPS
    cand_launches, cand = candidate_paths(gen)
    emit({"phase": "candidate_paths", "launches": cand_launches, **cand})
    emit({"phase": "index_paths", "card": card, "k": K, "users": N_QUERIES,
          "items": N_ITEMS, **service_paths(model, svc.item_embs, users)})

    # 5. the training path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, last_batch, train = train_criteo()
    emit({"phase": "train", "card": card, "wall_s": time.perf_counter() - t0,
          **train})
    eager_c = train_breakdown(trainer, last_batch)
    emit({"phase": "train_breakdown", "card": card, **eager_c})
    del trainer, last_batch

    # 5b. the sequential training path: SASRec over 1M items through B2
    t0 = time.perf_counter()
    trainer, batch, sas = train_sasrec_1m()
    emit({"phase": "train_sasrec_1m", "card": card,
          "wall_s": time.perf_counter() - t0, **sas})
    eager_d = sasrec_breakdown(trainer, batch)
    emit({"phase": "sasrec_breakdown", "card": card, **eager_d})
    del trainer, batch
    emit({"phase": "sasrec_markov", **sasrec_markov_on_card()})
    emit({"phase": "sasrec_60k", "card": card, **sasrec_60k_comparison()})

    # 5c. DeepFM fit at the Criteo width: train_steps_fused over B1
    trainer, batch, fit_c = fit_criteo()
    emit({"phase": "fit_criteo", "card": card, **fit_c})
    graph_c = train_breakdown(trainer, batch, steps=lambda:
                              trainer.train_steps_fused(stacked([batch])))
    emit({"phase": "fit_criteo_breakdown", "card": card, **graph_c})
    del trainer, batch
    # 5d. SASRec fit at V = 1M: train_steps_fused over B2
    trainer, batch, fit_d = fit_sasrec_1m()
    emit({"phase": "fit_sasrec_1m", "card": card, **fit_d})
    graph_d = sasrec_breakdown(trainer, batch, steps=lambda:
                               trainer.train_steps_fused(stacked([batch])))
    emit({"phase": "fit_sasrec_breakdown", "card": card, **graph_d})
    del trainer, batch
    # 5e. the quality exits on the card
    exits = quality_exits_on_card()
    emit({"phase": "quality_exits", "card": card, "seeds": EXIT_SEEDS,
          **exits})
    # 5f. LightGCN from training to serving at bench.py's width, through B3
    t0 = time.perf_counter()
    lgcn = fit_lightgcn()
    emit({"phase": "fit_lightgcn", "card": card,
          "wall_s": time.perf_counter() - t0, **lgcn})
    # 5g. the matching exits on the card
    t0 = time.perf_counter()
    mexits = matching_exits_on_card()
    emit({"phase": "matching_exits", "card": card, "seeds": EXIT_SEEDS,
          "wall_s": time.perf_counter() - t0, **mexits})
    # 5h. the CTR zoo through B1 at the Criteo width
    t0 = time.perf_counter()
    zoo = zoo_criteo()
    emit({"phase": "zoo_criteo", "card": card,
          "wall_s": time.perf_counter() - t0, **zoo})
    # 5i. the cascade on the card
    emit({"phase": "cascade_ml1m_scale", "card": card,
          **cascade_on_card()})

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
    b1_times = {kind: time_b1(gen, kind) for kind in ("uniform", "zipf")}
    for t in b1_times.values():
        emit({"phase": "timing", "card": card,
              "kernel": "packed_adagrad_update", **t})
    b1_time = b1_times["uniform"]
    b2_time = time_b2(gen)
    emit({"phase": "timing", "card": card, "kernel": "fused_ce", **b2_time})
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
    b4_times = time_b4(gen)
    for t in b4_times.values():
        emit({"phase": "timing", "card": card, "kernel": "mips_topk", **t})
    b5_times = time_b5(gen)
    for t in b5_times:
        emit({"phase": "timing", "card": card, "kernel": "bitonic_topk", **t})
    b6_times = time_b6()
    for t in b6_times:
        emit({"phase": "timing", "card": card, "kernel": "embedding_gather",
              **t})

    kernels = []
    for variant in ("bf16", "int8"):
        t, c = timings[(variant, DIM)], checks[(variant, N_ITEMS, DIM)]
        t128 = timings[(variant, 128)]
        kernels.append({
            "name": f"mips_fused_topk[{variant}]", "route": "cuda",
            "source": "recbox_tpu_torch/csrc/mips_fused_topk.cu",
            "stage_a_source": "recbox_tpu_torch/csrc/mips_topk.cu",
            "replaces": "recbox_tpu/ops/pallas/mips_fused_topk.py:100",
            "launches": launches[variant], "max_abs_err": c["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "design": "(a) B4's packed segment-candidate kernel on its wgmma "
                      "route (TMA ring, two consumer warpgroups, the "
                      "segment fold in registers), winners candidate-major; "
                      "(b) B5's radix selection with B3's decode epilogue",
            "kernel_route": c["route"], "stage_launches": stages[variant],
            "stage_a_ms": t["stage_a_ms"], "stage_b_ms": t["stage_b_ms"],
            "tile_route_stage_a_ms": t["tile_route_stage_a_ms"],
            "earlier": "tile_route_stage_a_ms, timed in this run: stage (a) "
                       "on B4's tile route (WMMA tiles through a shared "
                       "score stage), as the first design computed it",
            "d128": {key: t128[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "stage_a_ms",
                "stage_b_ms", "tile_route_stage_a_ms")},
            "ptxas": b3_ptxas,
            "variants": ["bf16", "f32", "int8"], "matches_plain": True,
            "shape": {"n": N_ITEMS, "d": DIM, "q": N_QUERIES, "k": K},
            "behind_trained_lightgcn": {
                "shape": {"n": LG_ITEMS, "d": LG_DIM, "q": N_QUERIES,
                          "k": LG_K},
                "launches_a_query": lgcn["serve"][variant][
                    "launches_a_query"],
                "max_abs_err": lgcn["b3_check"][variant]["max_abs_err"],
                "kernel_route": lgcn["b3_check"][variant]["route"],
                **{key: lgcn["b3_at_this_shape"][variant][key] for key in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "stage_a_ms", "stage_b_ms")}}})
    kernels.append({
        "name": "packed_adagrad_update", "route": "cuda",
        "source": "recbox_tpu_torch/csrc/packed_delta.cu",
        "replaces": "recbox_tpu/ops/pallas/packed_delta.py:62",
        "launches": fit_c["b1_launches"]
        + zoo["run_ranking_experiment"]["b1_launches"]
        + zoo["xdeepfm"]["b1_launches"],
        "launches_by_path": {
            "fit_fused_graph": fit_c["b1_launches"],
            "train_step_eager": train["launches"],
            "zoo_dcnv2_run_ranking_experiment":
                zoo["run_ranking_experiment"]["b1_launches"],
            "zoo_xdeepfm_fused": zoo["xdeepfm"]["b1_launches"]},
        "device_ms_in_profiled_step": {
            "eager": (eager_c["groups"] or {}).get(
                "b1_packed_adagrad_update"),
            "graph_replay": (graph_c["groups"] or {}).get(
                "b1_packed_adagrad_update")},
        "max_abs_err": b1_checks["uniform"]["max_abs_err"],
        "ms": b1_time["ms"], "plain_ms": b1_time["plain_ms"],
        "bound_ms": b1_time["bound_ms"], "bound_by": b1_time["bound_by"],
        "library_ms": b1_time["library_ms"],
        "library": "pack.index_add_(0, ids, operand), the scatter alone",
        "design": "operand rows staged in shared memory slot by slot, "
                  "16-byte vector reductions (REDG.F32x4), a block's rows "
                  "of one id summed before their reductions",
        "ids": "uniform per field, as bench.py draws them",
        "zipf_ids": {key: b1_times["zipf"][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms")},
        "max_abs_err_zipf": b1_checks["zipf"]["max_abs_err"],
        "one_slot_dcnv2": {
            "slots": list(B1_ZOO_DIMS), "grads": "f32",
            "max_abs_err": zoo["b1_one_slot_check"]["max_abs_err"],
            **{key: zoo["b1_one_slot_time"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "device_ms_in_replayed_step": (zoo["dcnv2"][
                "replayed_step_profile"]["groups"] or {}).get(
                "b1_packed_adagrad_update")},
        "xdeepfm_layout": {
            "slots": list(B1_XDEEPFM_DIMS), "grads": "f32",
            "max_abs_err": zoo["b1_xdeepfm_check"]["max_abs_err"],
            **{key: zoo["b1_xdeepfm_time"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}},
        "ptxas": redesigned["packed_delta"], "matches_plain": True,
        "shape": {"pack": [NUM_CAT * VOCAB, 128], "rows": NUM_CAT * BATCH,
                  "slots": list(B1_DIMS), "grads": "bf16"}})
    b2_err = b2_checks[0]
    for name, key, errs, replaces in (
            ("fused_ce_forward", "fwd", {"lse": b2_err["lse"]},
             "recbox_tpu/ops/pallas/fused_ce.py:100"),
            ("fused_ce_backward", "bwd",
             {"du": b2_err["du"], "dt": b2_err["dt"]},
             "recbox_tpu/ops/pallas/fused_ce.py:212")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "recbox_tpu_torch/csrc/fused_ce.cu",
            "replaces": replaces,
            "launches": fit_d["b2_launches"][f"fused_ce_{key}"],
            "launches_by_path": {
                "fit_fused_graph": fit_d["b2_launches"][f"fused_ce_{key}"],
                "train_steps_repeat_eager": sas["launches"][
                    f"fused_ce_{key}"]},
            "device_ms_in_profiled_step": {
                "eager": (eager_d["groups"] or {}).get(
                    "b2_forward" if key == "fwd" else "b2_backward"),
                "graph_replay": (graph_d["groups"] or {}).get(
                    "b2_forward" if key == "fwd" else "b2_backward")},
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "ms": b2_time[f"{key}_ms"],
            "plain_ms": b2_time[f"{key}_plain_ms"],
            "bound_ms": b2_time[f"{key}_bound_ms"],
            "bound_by": b2_time[f"{key}_bound_by"],
            "bound_what": b2_time[f"{key}_bound_what"],
            "exp_floor_ms": b2_time["exp_floor_ms"],
            "library_ms": b2_time["fwd_library_ms" if key == "fwd"
                                  else "fwd_bwd_library_ms"],
            "library": "F.cross_entropy(u_bf16 @ t_bf16.T, labels)"
                       + ("" if key == "fwd" else ", forward + backward"),
            "design": B2_DESIGN[key],
            "ptxas": [u for u in redesigned["fused_ce"]
                      if f"ce_{key}" in u["function"]],
            "plans": {f"b{c['b']}_v{c['v']}_d{c['d']}": c["plan"]
                      for c in b2_checks if c.get("plan")},
            "matches_plain": True, "repeats_bit_identical": True,
            "shape": {"b": SAS_B, "v": SAS_V, "d": SAS_D}})
    for (name, _, _), line in zip(B4_VARIANTS, (332, 315, 340)):
        t, t64 = b4_times[name, B4_D], b4_times[name, DIM]
        errs = [c["max_abs_err"] for c in b4_checks if c["variant"] == name]
        kernels.append({
            "name": f"mips_segment_candidates[{name}]", "route": "cuda",
            "source": "recbox_tpu_torch/csrc/mips_topk.cu",
            "replaces": f"recbox_tpu/ops/pallas/mips_topk.py:{line}",
            "launches": cand_launches[name], "max_abs_err": max(errs),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "per 1024 queries: cuBLAS scores (bf16 matmul or "
                       "torch._int_mm) + strided segment amax/max",
            "kernel_route": t["route"], "tile_route_ms": t["tile_route_ms"],
            "d64": {key: t64[key] for key in (
                "route", "ms", "tile_route_ms", "plain_ms", "library_ms",
                "bound_ms")},
            "ptxas": redesigned["mips_topk"] if t["route"] == "wgmma"
            else None,
            "matches_plain": True,
            "shape": {"n": B4_N, "d": B4_D, "q": B4_Q,
                      "query_tile": B4_TILE}})
    t5 = b5_times[0]
    kernels.append({
        "name": "bitonic_topk", "route": "cuda",
        "source": "recbox_tpu_torch/csrc/bitonic_topk.cu",
        "replaces": "recbox_tpu/ops/pallas/bitonic_topk.py:123",
        "launches": cand_launches["bitonic_topk"],
        "max_abs_err": max(c["max_abs_err"] for c in b5_checks),
        "ms": t5["ms"], "plain_ms": t5["plain_ms"],
        "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
        "library_ms": t5["library_ms"],
        "library": "torch.topk on the (Q, C) view",
        "design": "radix selection over keys in registers, then a sort of "
                  "the k survivors",
        "queries_a_block": t5["queries_a_block"],
        "merge_only": {f"k={t['k']}": {key: t[key] for key in (
            "ms", "library_ms", "bound_ms")} for t in b5_times[1:]},
        "ptxas": redesigned["bitonic_topk"], "matches_plain": True,
        "shape": {"c": t5["c"], "q": t5["q"], "k": t5["k"]}})
    t6, t6u = b6_times[0], b6_times[2]
    kernels.append({
        "name": "seq_embedding_pool", "route": "cuda",
        "source": "recbox_tpu_torch/csrc/embedding_gather.cu",
        "replaces": "recbox_tpu/ops/pallas/embedding_gather.py:94",
        "launches": cand_launches["seq_embedding_pool"],
        "max_abs_err": max(c["max_abs_err"] for c in b6_checks),
        "ms": t6["ms"], "plain_ms": t6["plain_ms"],
        "bound_ms": t6["bound_ms"], "bound_by": t6["bound_by"],
        "library_ms": t6["library_ms"],
        "library": "F.embedding_bag(ids, table, mode='mean', padding_idx)",
        "ids": "zipf(1.2), rows L2-resident across the timed run",
        "ms_int32_ids": t6["ms_int32_ids"],
        "uniform_ids": {key: t6u[key] for key in (
            "ms", "ms_int32_ids", "plain_ms", "library_ms", "bound_ms",
            "distinct_rows_mb")},
        "ptxas": redesigned["embedding_gather"], "matches_plain": True,
        "repeats_bit_identical": True,
        "shape": {"v": B6_V, "b": B6_B, "l": B6_L, "d": t6["d"]}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
