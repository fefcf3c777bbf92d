"""Row-wise exact top-k: the CUDA kernel, its plain PyTorch version, the
wrappers.

Port of the TPU kernel `recbox_tpu/ops/pallas/bitonic_topk.py`
(`pallas_bitonic_topk_cmajor` :152, `pallas_bitonic_topk` :189): the k
largest (score, id) pairs of each query, descending. The JAX kernel padded
the candidates to a power of two with (-inf, -1), sorted 4096-candidate
blocks in VMEM and recursed on the survivors; that recursion was for VMEM,
and the function is what is ported.

The order is total: score descending, then candidate position ascending,
which is `lax.top_k`'s order (JAX's network leaves equal scores in no set
order). The kernel selects on, and the plain version sorts, the same 64-bit
keys (`order_keys`), so they agree bit for bit. The kernel
(`csrc/bitonic_topk.cu` over `csrc/select_topk.cuh`, built by
`ops/_build.py`: up to 16384 candidates a radix selection over keys held in
registers, then a sort of the k survivors; past that, while 2k <= 16384,
a streaming filter on a running threshold; beyond, its global-memory mode,
for any k <= C; B3's stage (b) runs the same selection) runs for CUDA
tensors, `bitonic_topk_plain` for CPU tensors; a
CUDA tensor never reaches the plain version, and a failed build or launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from recbox_tpu_torch.ops import _build
from recbox_tpu_torch.utils import tracing

__all__ = ["pallas_bitonic_topk", "pallas_bitonic_topk_cmajor",
           "bitonic_topk_plain", "exact_topk", "order_keys", "select_plan",
           "large_scratch", "large_scratch_bytes", "LARGE", "launches",
           "stream_launches", "large_launches", "reset_launches"]

# kernel launches on the CUDA path; the plain version never counts
launches = tracing.register("bitonic_topk.launches", {"bitonic_topk": 0})
# of them, the launches on the streaming path (past one 16384-key window
# while 2k <= 16384) and in the global-memory mode (k above 8192 over more
# than 16384 candidates)
stream_launches = tracing.register("bitonic_topk.stream_launches",
                                   {"bitonic_topk": 0})
large_launches = tracing.register("bitonic_topk.large_launches",
                                  {"bitonic_topk": 0})

# the kernel's window: at most this many keys selected together
_MAX_SORT = 16384
_LOW32 = 0xFFFFFFFF
# the plan's queries a block of the global-memory mode
LARGE = 0
# its scratch a chunk of queries (csrc/select_topk.cuh `large_layout`): a
# row's first-digit histogram of each of up to 8 splits, its state, its
# threshold bin's keys (C u64), its k survivors (u64; past one sorted run
# of 16384 twice, and the merges' split points)
LARGE_SCRATCH_BYTES = 2 << 30
_LARGE_MAX_CHUNK = 65535 * 32
_HIST_BINS = 2048
_STATE_INTS = 20
_MAX_SPLITS = 8
_LARGE_RUN = 16384
_MERGE_TILE = 512 * 8


def reset_launches() -> None:
    for name in launches:
        launches[name] = stream_launches[name] = large_launches[name] = 0


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys of f32 ``scores`` (..., C) that sort descending as the
    port's top-k order: the float's bits made to sort as an integer in the
    high 32 bits, the inverted position in the low 32 (the kernel's key)."""
    bits = scores.to(torch.float32).view(torch.int32)
    ks = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    pos = torch.arange(scores.shape[-1], dtype=torch.int64,
                       device=scores.device)
    return (ks.to(torch.int64) << 32) | (_LOW32 - pos)


def _decode(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    ks = (keys >> 32).to(torch.int32)
    bits = ks ^ ((ks >> 31) & 0x7FFFFFFF)
    return bits.view(torch.float32), _LOW32 - (keys & _LOW32)


def exact_topk(scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values f32, positions int64), each (Q, k), of the row-wise top-k
    of ``scores`` (Q, C) in the port's order, in plain PyTorch. Values are
    the input's f32 bits. The candidate generator's merges use it."""
    keys = torch.topk(order_keys(scores), k, dim=1).values
    return _decode(keys)


def bitonic_topk_plain(scores: torch.Tensor, ids: Optional[torch.Tensor],
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function on row-major (Q, C) scores and ids (or the
    column positions): ((Q, k) f32, (Q, k) int32)."""
    vals, pos = exact_topk(scores, k)
    if ids is None:
        return vals, pos.to(torch.int32)
    return vals, torch.gather(ids.to(torch.int32), 1, pos)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("bitonic_topk")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.recbox_select_topk.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i,
                                       ll, ll, ll, ll, ll, ll, vp, ll, i, vp]
    lib.recbox_select_topk.restype = i
    return lib


# the kernel's shapes (csrc/select_topk.cuh): 256 threads a query, each
# with up to 64 keys in registers; a block's shared memory on sm_90 holds
# the staging of two vector loads a thread, and per query a 2048-bin
# histogram, a 32-byte state and the survivors' buffer
_THREADS = 256
_SMEM_LIMIT = 232448
_GROUP_FIXED = 2048 * 4 + 32
# the streaming path (`Stream`, `stream_fixed_bytes`): one query a block
# of 256 threads loading 8 scores a tile, or 4 adjacent queries of a
# candidate-major source a block of 512 loading 16; the block's fixed
# shared memory (histogram, state, counts, the scores of a tile that found
# no slot) ahead of a buffer of `cap` keys a query. An SM's shared memory
# is 228 KB, 1 KB of it reserved a block.
_SM_SMEM = 233472


def _stream_shape(qb: int) -> Tuple[int, int]:
    """(threads a block, scores a thread loads a tile)."""
    return (_THREADS, 8) if qb == 1 else (2 * _THREADS, 16)


def _stream_fixed(qb: int) -> int:
    threads, u = _stream_shape(qb)
    return 2048 * 4 + 32 + 16 * (threads // 32) + qb * 16 + threads * u * 4


def select_smem(qb: int, c: int, window: int, p: int) -> int:
    """Shared memory of the kernel's block for ``qb`` queries. One window
    (window = C): the staging of two vector loads a thread (qb > 1), then
    per query its histogram, state and a buffer of p 8-byte survivors, 512
    at least. The streaming path (window < C): the fixed part, then per
    query a buffer of ``window`` keys."""
    if window < c:
        return _stream_fixed(qb) + qb * window * 8
    staging = 2 * qb * qb * _THREADS * 4 if qb > 1 else 0
    return staging + qb * (_GROUP_FIXED + max(p, 2 * _THREADS) * 8)


def _stream_plan(k: int, p: int, cmajor: bool) -> Tuple[int, int, int, int]:
    """Over a candidate-major source (a 32-byte sector read by adjacent
    queries) 4 adjacent queries a block, with the smaller of two buffers
    that holds the sort's width and 2k and exceeds one query's buffer:
    2304 keys (what half an SM's shared memory holds) or 5952 (a block's
    most). Else one query a block with a buffer of max(1536, 2 * width)
    keys (at k <= 256, four blocks an SM). On the card the smaller buffer
    was the faster at k = 1 and 500 (its first fill, a sample of the row,
    is narrowed sooner), the larger twice as fast as one query a block
    between k = 1153 and 2048 (PERF.md)."""
    width = max(p, 2 * _THREADS)
    if cmajor:
        fixed = _stream_fixed(4)
        for cap in ((_SM_SMEM // 2 - 1024 - fixed) // 32 // 32 * 32,
                    (_SMEM_LIMIT - fixed) // 32 // 32 * 32):
            if cap >= max(width, 2 * k) and cap > 2 * width:
                return 4, cap, _stream_shape(4)[1], p
    return 1, max(1536, 2 * width), _stream_shape(1)[1], p


def select_plan(c: int, k: int, who: str = "bitonic_topk",
                cmajor: bool = False) -> Tuple[int, int, int, int]:
    """(queries a block, keys a window, keys a thread, survivor sort
    width) of the selection kernel (B5's, and B3's stage (b)), for any
    k <= C. Every candidate fits one window up to 16384: a block takes 4
    queries (16-byte loads of a candidate-major row) while a thread holds at
    most 32 keys and the block fits in shared memory; at 64 keys a thread 2
    queries; else 1. Past one window while 2k <= 16384 the streaming path:
    ``(queries a block, buffer keys a query (< C), keys a thread loads a
    tile, p)``, 4 adjacent queries a block of a candidate-major source
    (``cmajor``) where their buffers fit. Past one window at k above 8192
    the plan is ``(0, C, 0, p)``: the global-memory mode (`LARGE`), whose
    rows are selected and sorted in device memory."""
    if k > c:
        raise ValueError(f"{who}: k={k} > {c} candidates")
    p = 1 << max(1, (k - 1).bit_length())
    if c > _MAX_SORT:
        if 2 * k > _MAX_SORT:
            return LARGE, c, 0, p
        return _stream_plan(k, p, cmajor)
    kpt = max(8, 1 << (-(-c // _THREADS) - 1).bit_length())
    for qb in (4, 2, 1):
        # the kernel's instantiations: 8-32 keys a thread at 4 queries a
        # block, 64 at 2, 32 or 64 at 1
        built = {4: kpt <= 32, 2: kpt == 64, 1: kpt >= 32}[qb]
        if built and select_smem(qb, c, c, p) <= _SMEM_LIMIT:
            return qb, c, kpt, p
    raise AssertionError("one query's window always fits")  # pragma: no cover


def _align256(n: int) -> int:
    return -(-n // 256) * 256


def large_scratch_bytes(rows: int, c: int, k: int) -> int:
    """Bytes of the global-memory mode's scratch for ``rows`` queries over
    C candidates at k (csrc/select_topk.cuh `large_layout`)."""
    runs = k > _LARGE_RUN
    tiles = -(-k // _MERGE_TILE)
    n = (_align256(_MAX_SPLITS * rows * _HIST_BINS * 4)
         + _align256(rows * _STATE_INTS * 4)
         + _align256(rows * c * 8) + _align256(rows * k * 8))
    if runs:
        n += _align256(rows * k * 8) + _align256(rows * tiles * 4)
    return n


def large_scratch(q: int, c: int, k: int, device
                  ) -> Tuple[torch.Tensor, int]:
    """(scratch bytes, queries a chunk) of the global-memory mode for Q
    queries over C candidates at k: as many queries a chunk as fit
    `LARGE_SCRATCH_BYTES` (one at least)."""
    row = _MAX_SPLITS * _HIST_BINS * 4 + _STATE_INTS * 4 + c * 8 + k * 8
    if k > _LARGE_RUN:
        row += k * 8 + 4 * -(-k // _MERGE_TILE)
    chunk = max(1, min(q, (LARGE_SCRATCH_BYTES - 6 * 256) // row,
                       _LARGE_MAX_CHUNK))
    return (torch.empty(large_scratch_bytes(chunk, c, k), dtype=torch.uint8,
                        device=device), chunk)


def _bitonic_cuda(scores, ids, k, out_s, out_i):
    """Launch the kernel on (Q, C) views ``scores``/``ids`` of any strides
    into (Q, k) views ``out_s``/``out_i`` of any strides."""
    dev = scores.device
    if not (scores.is_cuda and (ids is None or ids.device == dev)):
        raise ValueError(f"bitonic_topk: scores on {dev}; the kernel takes "
                         "scores and ids on one CUDA device")
    q, c = scores.shape
    cmajor = scores.stride(0) == 1 and scores.stride(1) != 1
    qb, window, kpt, p = select_plan(c, k, cmajor=cmajor)
    scratch, nbytes, chunk = None, 0, 0
    if qb == LARGE:
        # the mode reads a row-major or a candidate-major source
        if scores.stride(1) != 1 and scores.stride(0) != 1:
            scores = scores.contiguous()
        scratch, chunk = large_scratch(q, c, k, dev)
        nbytes = scratch.numel()
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.recbox_select_topk(
            scores.data_ptr(), None if ids is None else ids.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), q, c, k, p, window,
            qb, kpt,
            scores.stride(0), scores.stride(1),
            0 if ids is None else ids.stride(0),
            0 if ids is None else ids.stride(1),
            out_s.stride(0), out_s.stride(1),
            None if scratch is None else scratch.data_ptr(), nbytes, chunk,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bitonic_topk: launch failed with CUDA error {rc}")
    launches["bitonic_topk"] += 1
    if qb == LARGE:
        large_launches["bitonic_topk"] += 1
    elif window < c:
        stream_launches["bitonic_topk"] += 1


def row_topk(scores: torch.Tensor, ids: Optional[torch.Tensor], k: int,
             out_cmajor: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (Q, C) views of any strides (a `.T` of a candidate-major
    array is read in place): ((Q, k), (Q, k)), or ((k, Q), (k, Q)) with
    ``out_cmajor``. The kernel for CUDA tensors, the plain version for CPU
    tensors. Scores come back in their dtype, ids int32."""
    q, c = scores.shape
    if k > c:
        raise ValueError(f"k={k} > {c} candidates")
    if ids is not None:
        ids = ids.to(torch.int32)
        if tuple(ids.shape) != (q, c):
            raise ValueError(f"ids {tuple(ids.shape)} vs scores {(q, c)}")
    dtype = scores.dtype
    scores = scores.to(torch.float32)
    if scores.device.type == "cpu":
        s, i = bitonic_topk_plain(scores, ids, k)
        if out_cmajor:
            s, i = s.T.contiguous(), i.T.contiguous()
        return s.to(dtype), i
    shape = (k, q) if out_cmajor else (q, k)
    out_s = torch.empty(shape, dtype=torch.float32, device=scores.device)
    out_i = torch.empty(shape, dtype=torch.int32, device=scores.device)
    if q:
        _bitonic_cuda(scores, ids, k,
                      out_s.T if out_cmajor else out_s,
                      out_i.T if out_cmajor else out_i)
    return out_s.to(dtype), out_i


def pallas_bitonic_topk_cmajor(scores_cm: torch.Tensor, ids_cm: torch.Tensor,
                               k: int, q_tile: int = 128
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate-major top-k: (C, Q) scores and ids → ((k, Q), (k, Q)),
    descending down each column.

    The layout the candidate generator emits, read in place (no transpose).
    ``q_tile`` was the JAX kernel's query tile in VMEM and has no meaning
    here: it is accepted and ignored. Any k <= C; raises ValueError for
    k > C (JAX's own kernel stops at k <= 2048 over more than 4096
    candidates: it raises once the power of two at or above k reaches its
    4096-candidate block)."""
    return row_topk(scores_cm.T, ids_cm.T, k, out_cmajor=True)


def pallas_bitonic_topk(scores: torch.Tensor,
                        ids: Optional[torch.Tensor] = None, k: int = 100,
                        q_tile: int = 128
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise exact top-k, descending: (Q, C) → ((Q, k), (Q, k)).

    ``ids`` defaults to the column index. ``q_tile`` is accepted and
    ignored, as in `pallas_bitonic_topk_cmajor`."""
    return row_topk(scores, ids, k)
