"""Fused MIPS top-k: the CUDA kernels, their plain PyTorch version, the
wrapper.

Port of the TPU kernel `recbox_tpu/ops/pallas/mips_fused_topk.py`
(`mips_fused_topk` :197). For each query it returns the exact top-k of the
corpus's segment winners: every row is scored in f32 accumulation,
clipped to ±PACK_FLOOR, rows >= ``valid_items`` are set to -PACK_FLOOR, the
row's in-segment index rides the low 7 mantissa bits, and each 128-row
segment keeps its float max (`ops/mips_topk.py` has the segment plan). Recall
loses only to segment collisions, ~k·128/(2N); returned scores carry the
2^-17 truncation of the packing.

For CUDA tensors the function is two launches (`csrc/mips_fused_topk.cu`,
built by `ops/_build.py`): stage (a), the packed form of B4's
segment-candidate kernel (`ops/mips_topk.py`: its `wgmma` route, its
segment route below 911 queries, or its tile route, as `candidate_route`
takes the dtype, depth and plan), writes the winners candidate-major; stage (b), B5's selection with this
kernel's epilogue (past 16384 winners its streaming path while 2k <=
16384, 4 adjacent queries a block, and its global-memory mode beyond),
selects the k largest packed winners of each query and decodes them.
`mips_fused_topk_plain` runs for CPU tensors; a CUDA tensor never reaches
it, and a failed build or launch raises. The plain version
also serves as the kernels' yardstick in `chip_smoke.py` and the tests.

Ties: packed score descending, then candidate position ascending (B5's
order, `lax.top_k`'s); the JAX kernel sets no order among equal scores.

The segment plan, and so the candidate set, is the JAX package's: the
sub-chunk size follows its block plan for the query tile (`block_plan`,
`mips_fused_topk.py:226-228`), and candidates are counted over the corpus
padded to its grid block (`:236-265`), so a k above the live candidates
returns (-inf, -1) pads where JAX does, and raises only where JAX raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from recbox_tpu_torch.ops import _build
from recbox_tpu_torch.ops.bitonic_topk import (
    LARGE, exact_topk, large_scratch, select_plan,
)
from recbox_tpu_torch.ops.mips_topk import (
    SEGMENT, _candidates_cuda, block_plan, decode_winners,
    mips_segment_candidates_plain, quantize_int8,
)
from recbox_tpu_torch.utils import tracing

__all__ = ["mips_fused_topk", "mips_fused_topk_plain", "segment_plan",
           "select_winners", "launches", "stream_launches", "large_launches",
           "reset_launches"]

# launches of the selection, one a call through the kernels, by corpus
# dtype (stage (a) counts in `mips_topk`'s `launches` and
# `route_launches`); the plain version never counts
launches = tracing.register("mips_fused_topk.launches",
                            {"f32": 0, "bf16": 0, "int8": 0})
# of them, the selections on the streaming path (past 16384 winners while
# 2k <= 16384) and in the global-memory mode (k above 8192 over more than
# 16384 winners)
stream_launches = tracing.register("mips_fused_topk.stream_launches",
                                   {"f32": 0, "bf16": 0, "int8": 0})
large_launches = tracing.register("mips_fused_topk.large_launches",
                                  {"f32": 0, "bf16": 0, "int8": 0})

_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}


def reset_launches() -> None:
    for name in launches:
        launches[name] = stream_launches[name] = large_launches[name] = 0


def segment_plan(corpus_dtype: torch.dtype, n: int, d: int, nq: int, k: int,
                 query_tile: int = 1024) -> Tuple[int, int]:
    """(sub_rows, candidates) of the JAX kernel for these shapes: the
    sub-chunk size of its block plan for a query tile of min(query_tile,
    nq), and its candidate count, one per 128 rows of the corpus padded to
    its grid block (`mips_fused_topk.py:226-242`)."""
    qt = min(query_tile, max(nq, 1))
    itemsize = torch.empty((), dtype=corpus_dtype).element_size()
    sub_rows, spb = block_plan(itemsize, qt, d + (-d) % 128)
    kp = 1 << max(1, (max(k, 2) - 1).bit_length())
    block_mult = 2 if kp >= 2 * spb * sub_rows // SEGMENT else 1
    c_block = sub_rows * spb * block_mult
    return sub_rows, -(-n // c_block) * c_block // SEGMENT


def mips_fused_topk_plain(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                          valid_items: int, row_scale=None, q_scale=None,
                          sub_rows: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' function in plain PyTorch, for
    k <= ceil(N / sub_rows) · sub_rows / 128: the packed segment winners of
    the candidate generator's plain version (`mips_topk.py`), their exact
    top-k in B5's order (`exact_topk`), then the decode.

    bf16 inputs are upcast and multiplied in f32, which equals bf16 × bf16
    products summed in f32; int8 rows are exact integers in f32 while
    D·127² < 2^24, else in f64. On the card it needs
    ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    win = mips_segment_candidates_plain(queries, corpus, valid_items, True,
                                        row_scale, sub_rows)
    vals, pos = exact_topk(win.T, k)
    return decode_winners(vals, pos, sub_rows, q_scale)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("mips_fused_topk")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.recbox_mips_select_winners.argtypes = [
        vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp, ctypes.c_longlong, i, vp]
    lib.recbox_mips_select_winners.restype = i
    return lib


def select_winners(winners: torch.Tensor, q_scale: Optional[torch.Tensor],
                   out_s: torch.Tensor, out_i: torch.Tensor, k: int,
                   sub_rows: int) -> str:
    """Stage (b) alone: the top k of the (n_cand, Q) packed ``winners``
    (contiguous, on the card) decoded into ``out_s`` / ``out_i`` (Q, k),
    by B5's plan for a candidate-major source. Returns the path taken:
    'window' (16384 winners or fewer), 'stream' (more, while 2k <= 16384)
    or 'large' (the global-memory mode, with its scratch)."""
    n_cand, nq = winners.shape
    qb, window, kpt, p = select_plan(n_cand, k, "mips_fused_topk",
                                     cmajor=True)
    scratch, nbytes, chunk = None, 0, 0
    if qb == LARGE:
        scratch, chunk = large_scratch(nq, n_cand, k, winners.device)
        nbytes = scratch.numel()
    rc = _kernel_lib().recbox_mips_select_winners(
        winners.data_ptr(),
        None if q_scale is None else q_scale.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), nq, n_cand, k, p, window, qb,
        kpt, sub_rows, None if scratch is None else scratch.data_ptr(),
        nbytes, chunk, torch.cuda.current_stream(winners.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mips_fused_topk: the selection failed with CUDA "
                           f"error {rc}")
    if qb == LARGE:
        return "large"
    return "stream" if window < n_cand else "window"


def _mips_fused_topk_cuda(queries, corpus, k, valid, row_scale, q_scale,
                          sub_rows):
    nq, n = queries.shape[0], corpus.shape[0]
    n_cand = -(-n // sub_rows) * (sub_rows // SEGMENT)
    # B5's plan, for any k <= C (it raises for k > C)
    select_plan(n_cand, k, "mips_fused_topk")
    dev = corpus.device
    if not (corpus.is_cuda and queries.device == dev):
        raise ValueError(f"mips_fused_topk: queries on {queries.device}, "
                         f"corpus on {dev}; the kernel takes both on one "
                         "CUDA device")
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    winners = torch.empty((n_cand, nq), dtype=torch.float32, device=dev)
    _candidates_cuda(queries, corpus, valid, True, row_scale, sub_rows,
                     winners, None)
    if q_scale is not None:
        q_scale = q_scale.contiguous()
    with torch.cuda.device(dev):
        path = select_winners(winners, q_scale, out_s, out_i, k, sub_rows)
    name = _NAMES[corpus.dtype]
    launches[name] += 1
    if path == "large":
        large_launches[name] += 1
    elif path == "stream":
        stream_launches[name] += 1
    return out_s, out_i


def mips_fused_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                    valid_items: Optional[int] = None,
                    row_scale: Optional[torch.Tensor] = None,
                    query_tile: int = 1024
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (scores (Q, k) f32, ids (Q, k) int32) of ``corpus`` per query.

    queries (Q, D) float; corpus (N, D) float32, bfloat16 or int8. Queries
    are cast to a float corpus's dtype; over an int8 corpus (the rows of
    `quantize_int8`, with its per-row ``row_scale`` (N,)) they are quantized
    per row on the fly and the per-query scale is applied to the k winners
    (a positive factor, so the ranking is the same). ``valid_items`` marks
    rows >= it as padding. ``query_tile`` is the JAX kernel's query tile,
    which sets the segment plan (`segment_plan`). Slots past the live
    candidates return score -inf and id -1.
    """
    quantized = corpus.dtype == torch.int8
    if quantized and row_scale is None:
        raise ValueError("int8 corpus requires row_scale (the quantize_int8 "
                         "per-row scales)")
    if not quantized and row_scale is not None:
        raise ValueError("row_scale is only meaningful for an int8 corpus")
    if corpus.dtype not in _NAMES:
        raise TypeError(f"mips_fused_topk: corpus dtype {corpus.dtype}; "
                        "expected float32, bfloat16 or int8")
    if queries.ndim != 2 or corpus.ndim != 2 \
            or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"mips_fused_topk: queries {tuple(queries.shape)} "
                         f"vs corpus {tuple(corpus.shape)}")
    n = corpus.shape[0]
    if quantized:
        row_scale = row_scale.reshape(-1)
        if row_scale.shape[0] != n:
            raise ValueError(f"row_scale has {row_scale.shape[0]} entries "
                             f"for a {n}-row corpus")
    sub_rows, n_cand = segment_plan(corpus.dtype, n, corpus.shape[1],
                                    queries.shape[0], k, query_tile)
    if k > n_cand:
        raise ValueError(f"mips_fused_topk: k={k} exceeds the {n_cand} "
                         f"segment candidates for a {n}-row corpus")
    # candidates past ceil(N / sub_rows) sub-chunks hold only pad rows: JAX
    # returns them as (-inf, -1), so they are appended, never computed
    k_run = min(k, -(-n // sub_rows) * (sub_rows // SEGMENT))
    valid = n if valid_items is None else min(int(valid_items), n)
    q_scale = None
    if quantized:
        queries, q_scale = quantize_int8(queries)
    else:
        queries = queries.to(corpus.dtype)
    if corpus.device.type == "cpu":
        s, i = mips_fused_topk_plain(queries, corpus, k_run, valid,
                                     row_scale, q_scale, sub_rows)
    else:
        s, i = _mips_fused_topk_cuda(queries, corpus, k_run, valid,
                                     row_scale, q_scale, sub_rows)
    if k_run < k:
        s = F.pad(s, (0, k - k_run), value=float("-inf"))
        i = F.pad(i, (0, k - k_run), value=-1)
    return s, i
