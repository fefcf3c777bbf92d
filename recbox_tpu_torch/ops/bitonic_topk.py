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
`ops/_build.py`: a radix selection over keys held in registers, then a sort
of the k survivors; past one 16384-key window at k above 8192 its
global-memory mode, for any k <= C; B3's stage (b) runs the same
selection) runs for CUDA tensors, `bitonic_topk_plain` for CPU tensors; a
CUDA tensor never reaches the plain version, and a failed build or launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from recbox_tpu_torch.ops import _build

__all__ = ["pallas_bitonic_topk", "pallas_bitonic_topk_cmajor",
           "bitonic_topk_plain", "exact_topk", "order_keys", "select_plan",
           "large_scratch", "LARGE", "launches", "large_launches",
           "reset_launches"]

# kernel launches on the CUDA path; the plain version never counts
launches = {"bitonic_topk": 0}
# of them, the launches in the global-memory mode (k above 8192 over more
# than 16384 candidates)
large_launches = {"bitonic_topk": 0}

# the kernel's window: at most this many keys selected together
_MAX_SORT = 16384
_LOW32 = 0xFFFFFFFF
# the plan's queries a block of the global-memory mode
LARGE = 0
# its scratch a chunk of queries: (rows, C) u32 keys and (rows, p) u64
# survivors (csrc/select_topk.cuh `launch_select_large`)
LARGE_SCRATCH_BYTES = 1 << 30
_LARGE_MAX_CHUNK = 65535 * 32


def reset_launches() -> None:
    for name in launches:
        launches[name] = large_launches[name] = 0


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
                                       ll, ll, ll, ll, ll, ll, vp, vp, i, vp]
    lib.recbox_select_topk.restype = i
    return lib


# the kernel's shapes (csrc/select_topk.cuh): 256 threads a query, each
# with up to 64 keys in registers; a block's shared memory on sm_90 holds
# the staging of two vector loads a thread, and per query a 2048-bin
# histogram, a 32-byte state and the survivors' buffers
_THREADS = 256
_SMEM_LIMIT = 232448
_GROUP_FIXED = 2048 * 4 + 32


def select_smem(qb: int, c: int, window: int, p: int) -> int:
    """Shared memory of the kernel's block for ``qb`` queries: the staging
    of two vector loads a thread (qb > 1), then per query its histogram,
    state and one buffer of p 8-byte survivors, 512 at least (two when
    windowed: carry and next)."""
    nbuf = 2 if window < c else 1
    staging = 2 * qb * qb * _THREADS * 4 if qb > 1 else 0
    return staging + qb * (_GROUP_FIXED + nbuf * max(p, 2 * _THREADS) * 8)


def select_plan(c: int, k: int, who: str = "bitonic_topk"
                ) -> Tuple[int, int, int, int]:
    """(queries a block, keys a window, keys a thread, survivor sort
    width) of the selection kernel (B5's, and B3's stage (b)), for any
    k <= C. Every candidate fits one window up to 16384; past that, windows
    of 16384 carry the top k from one to the next while 2k <= 16384. A
    block takes 4 queries (16-byte loads of a candidate-major row) while a
    thread holds at most 32 keys and the block fits in shared memory; at
    64 keys a thread 2 queries; else, and when windowed, 1. Past one window
    at k above 8192 the plan is ``(0, C, 0, p)``: the global-memory mode
    (`LARGE`), whose rows are selected and sorted in device memory."""
    if k > c:
        raise ValueError(f"{who}: k={k} > {c} candidates")
    p = 1 << max(1, (k - 1).bit_length())
    window = min(c, _MAX_SORT)
    if window < c and 2 * k > _MAX_SORT:
        return LARGE, c, 0, p
    kpt = max(8, 1 << (-(-window // _THREADS) - 1).bit_length())
    for qb in ((4, 2, 1) if window == c else (1,)):
        # the kernel's instantiations: 8-32 keys a thread at 4 queries a
        # block, 64 at 2, 32 or 64 at 1
        built = {4: kpt <= 32, 2: kpt == 64, 1: kpt >= 32}[qb]
        if built and select_smem(qb, c, window, p) <= _SMEM_LIMIT:
            return qb, window, kpt, p
    raise AssertionError("one query's window always fits")  # pragma: no cover


def large_scratch(q: int, c: int, p: int, device, keys: bool = True
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor, int]:
    """(keys, survivors, queries a chunk) of the global-memory mode for
    Q queries over C candidates: as many queries a chunk as fit
    `LARGE_SCRATCH_BYTES` (one at least). The (chunk, C) order keys only
    with ``keys`` (a candidate-major source; a row-major one is read in
    place), else None."""
    row = c * 4 * keys + p * 8
    chunk = max(1, min(q, LARGE_SCRATCH_BYTES // row, _LARGE_MAX_CHUNK))
    return (torch.empty((chunk, c), dtype=torch.int32, device=device)
            if keys else None,
            torch.empty((chunk, p), dtype=torch.int64, device=device), chunk)


def _bitonic_cuda(scores, ids, k, out_s, out_i):
    """Launch the kernel on (Q, C) views ``scores``/``ids`` of any strides
    into (Q, k) views ``out_s``/``out_i`` of any strides."""
    dev = scores.device
    if not (scores.is_cuda and (ids is None or ids.device == dev)):
        raise ValueError(f"bitonic_topk: scores on {dev}; the kernel takes "
                         "scores and ids on one CUDA device")
    q, c = scores.shape
    qb, window, kpt, p = select_plan(c, k)
    keys = surv = None
    chunk = 0
    if qb == LARGE:
        # the mode reads a row-major or a candidate-major source
        if scores.stride(1) != 1 and scores.stride(0) != 1:
            scores = scores.contiguous()
        keys, surv, chunk = large_scratch(q, c, p, dev,
                                          keys=scores.stride(1) != 1)
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
            None if keys is None else keys.data_ptr(),
            None if surv is None else surv.data_ptr(), chunk,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bitonic_topk: launch failed with CUDA error {rc}")
    launches["bitonic_topk"] += 1
    if qb == LARGE:
        large_launches["bitonic_topk"] += 1


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
