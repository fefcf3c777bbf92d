"""Fused MIPS top-k: the CUDA kernel, its plain PyTorch version, the wrapper.

Port of the TPU kernel `recbox_tpu/ops/pallas/mips_fused_topk.py`
(`mips_fused_topk` :197). For each query it returns the exact top-k of the
corpus's segment winners: every row is scored in f32 accumulation,
clipped to ±PACK_FLOOR, rows >= ``valid_items`` are set to -PACK_FLOOR, the
row's in-segment index rides the low 7 mantissa bits, and each 128-row
segment keeps its float max (`ops/mips_topk.py` has the segment plan). Recall
loses only to segment collisions, ~k·128/(2N); returned scores carry the
2^-17 truncation of the packing.

The kernel (`csrc/mips_fused_topk.cu`, built by `ops/_build.py`) runs for
CUDA tensors, `mips_fused_topk_plain` for CPU tensors; a CUDA tensor never
reaches the plain version, and a failed build or launch raises. The plain
version also serves as the kernel's yardstick in `chip_smoke.py` and the
tests.

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
from recbox_tpu_torch.ops.mips_topk import (
    PACK_FLOOR, PACK_MASK, SEGMENT, block_plan, quantize_int8, winner_ids,
)

__all__ = ["mips_fused_topk", "mips_fused_topk_plain", "segment_plan",
           "launches", "reset_launches"]

# kernel launches on the CUDA path, by corpus dtype; the plain version
# never counts
launches = {"f32": 0, "bf16": 0, "int8": 0}

_VARIANTS = {torch.float32: ("f32", 0), torch.bfloat16: ("bf16", 1),
             torch.int8: ("int8", 2)}

# the sort of stage (b) works in windows of at most this many keys
_MAX_SORT = 16384
# queries a block of stage (a) scores (QT in csrc/mips_fused_topk.cu)
_QUERY_TILE = 64


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _order_key(win: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort like the f32 winners, the candidate position in
    the low 32 bits: a total order, the kernel's own (`order_key`)."""
    bits = win.view(torch.int32)
    ks = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    cand = torch.arange(win.shape[-1], dtype=torch.int64, device=win.device)
    return (ks.to(torch.int64) << 32) | cand


def _decode(keys: torch.Tensor, sub_rows: int, q_scale):
    ks = (keys >> 32).to(torch.int32)
    bits = ks ^ ((ks >> 31) & 0x7FFFFFFF)
    cand = keys & 0xFFFFFFFF
    clean = (bits & ~PACK_MASK).view(torch.float32)
    ids = winner_ids(cand, (bits & PACK_MASK).to(torch.int64), sub_rows)
    alive = clean > -PACK_FLOOR / 2
    if q_scale is not None:
        clean = clean * q_scale[:, None]
    return (torch.where(alive, clean, float("-inf")),
            torch.where(alive, ids, -1).to(torch.int32))


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
    """The kernel's function in plain PyTorch, in query chunks, for
    k <= ceil(N / sub_rows) · sub_rows / 128.

    bf16 inputs are upcast and multiplied in f32, which equals bf16 × bf16
    products summed in f32; int8 rows are exact integers in f32 while
    D·127² < 2^24, else in f64. On the card it needs
    ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    n = corpus.shape[0]
    dev = corpus.device
    n_seg = sub_rows // SEGMENT
    n_sub = -(-n // sub_rows)
    n_pad = n_sub * sub_rows
    wide = corpus.dtype == torch.int8 and corpus.shape[1] * 127 * 127 >= 2**24
    work = torch.float64 if wide else torch.float32
    cf = F.pad(corpus.to(work), (0, 0, 0, n_pad - n))
    live = torch.arange(n_pad, device=dev) < valid_items
    scale = None
    if row_scale is not None:
        scale = F.pad(row_scale.to(torch.float32), (0, n_pad - n), value=1.0)
    idx = torch.arange(SEGMENT, dtype=torch.int32, device=dev)
    idx = idx.view(1, 1, SEGMENT, 1)
    # a (step, n_pad) score block of 2^24 elements on the CPU, 2^27 on a card
    step = max(1, (2**24 if dev.type == "cpu" else 2**27) // n_pad)
    out_s, out_i = [], []
    for q0 in range(0, queries.shape[0], step):
        s = (queries[q0:q0 + step].to(work) @ cf.T).to(torch.float32)
        if scale is not None:
            s = s * scale
        s = torch.clamp(s, -PACK_FLOOR, PACK_FLOOR)
        s = torch.where(live, s, -PACK_FLOOR)
        bits = s.view(torch.int32).view(s.shape[0], n_sub, SEGMENT, n_seg)
        packed = ((bits & ~PACK_MASK) | idx).view(torch.float32)
        win = torch.amax(packed, dim=2).reshape(s.shape[0], n_sub * n_seg)
        keys = torch.topk(_order_key(win), k, dim=1).values
        qs = None if q_scale is None else q_scale[q0:q0 + step]
        ts, ti = _decode(keys, sub_rows, qs)
        out_s.append(ts)
        out_i.append(ti)
    return torch.cat(out_s), torch.cat(out_i)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("mips_fused_topk")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.recbox_mips_score_winners.argtypes = [i, vp, vp, vp, vp, i, i, i, i,
                                              i, i, vp]
    lib.recbox_mips_score_winners.restype = i
    lib.recbox_mips_topk_winners.argtypes = [vp, vp, vp, vp, i, i, i, i, i,
                                             vp]
    lib.recbox_mips_topk_winners.restype = i
    return lib


def _sort_width(n_cand: int, k: int) -> int:
    """Keys per window of the top-k sort: all candidates when they fit,
    else a window with k <= width/2."""
    full = 1 << max(1, (n_cand - 1).bit_length())
    width = min(full, 8192)
    if width < full and 2 * k > width:
        width = min(full, _MAX_SORT)
    if width < full and 2 * k > width:
        raise ValueError(f"mips_fused_topk: k={k} is above the kernel's "
                         f"{_MAX_SORT // 2} for {n_cand} candidates")
    return width


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"mips_fused_topk: {what} failed with CUDA error "
                           f"{rc}")


def _mips_fused_topk_cuda(queries, corpus, k, valid, row_scale, q_scale,
                          sub_rows):
    dev = corpus.device
    if not (corpus.is_cuda and queries.device == dev):
        raise ValueError(f"mips_fused_topk: queries on {queries.device}, "
                         f"corpus on {dev}; the kernel takes both on one "
                         "CUDA device")
    name, code = _VARIANTS[corpus.dtype]
    d_pad = (-corpus.shape[1]) % 16
    if d_pad:   # the kernel loads 16-byte vectors along the depth
        corpus = F.pad(corpus, (0, d_pad))
        queries = F.pad(queries, (0, d_pad))
    queries, corpus = queries.contiguous(), corpus.contiguous()
    nq, (n, d) = queries.shape[0], corpus.shape
    n_sub = -(-n // sub_rows)
    if n_sub > 65535:
        raise ValueError(f"mips_fused_topk: {n} rows exceed the kernel's "
                         f"{65535 * sub_rows} at sub_rows={sub_rows}")
    n_cand = n_sub * (sub_rows // SEGMENT)
    width = _sort_width(n_cand, k)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    if row_scale is not None:
        row_scale = row_scale.to(device=dev, dtype=torch.float32).contiguous()
    if q_scale is not None:
        q_scale = q_scale.contiguous()
    # a grid of fewer than two blocks per SM splits each sub-chunk's chunks
    # into runs, merged by atomic max into winners that start at -inf
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = -(-nq // _QUERY_TILE) * n_sub
    splits = min(sub_rows // SEGMENT, -(-2 * sms // blocks))
    if splits > 1:
        winners = torch.full((nq, n_cand), float("-inf"), device=dev)
    else:
        winners = torch.empty((nq, n_cand), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.recbox_mips_score_winners(
            code, queries.data_ptr(), corpus.data_ptr(),
            None if row_scale is None else row_scale.data_ptr(),
            winners.data_ptr(), nq, n, d, valid, sub_rows, splits, stream),
            "score_winners")
        _check(lib.recbox_mips_topk_winners(
            winners.data_ptr(),
            None if q_scale is None else q_scale.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), nq, n_cand, k, width,
            sub_rows, stream), "topk_winners")
    launches[name] += 1
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
    if corpus.dtype not in _VARIANTS:
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
