"""Fused sequence-embedding gather + masked pooling: the CUDA kernel, its
plain PyTorch version, the wrapper.

Port of the TPU kernel `recbox_tpu/ops/pallas/embedding_gather.py`
(`_kernel` :44, `_pallas_pool` :89, `seq_embedding_pool` :123):
``out[b] = Σ_l table[ids[b, l]] · [ids[b, l] != pad_id]``, divided by
max(count, 1e-12) for ``mode='mean'`` (a row of pads gives 0), accumulated
in f32 without the (B, L, D) gather in device memory.

The JAX function picks between its Pallas kernel (``interpret``, or
``force_pallas`` on a TPU, for D % 128 == 0 and B % 8 == 0) and its XLA
gather + pool (`seq_embedding_pool_xla`, the default everywhere); both
compute this function. Here the kernel (`csrc/embedding_gather.cu`, built
by `ops/_build.py`) runs for every CUDA tensor, at any D and B, and the
plain version for CPU tensors; neither argument has a counterpart. A CUDA
tensor never reaches the plain version, and a failed build or launch
raises. The output has the table's dtype, as JAX's default path returns.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from recbox_tpu_torch.ops import _build
from recbox_tpu_torch.utils import tracing

__all__ = ["seq_embedding_pool", "seq_embedding_pool_plain", "launches",
           "reset_launches"]

# kernel launches on the CUDA path; the plain version never counts
launches = tracing.register("embedding_gather.launches",
                            {"seq_embedding_pool": 0})

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = ("mean", "sum")


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def seq_embedding_pool_plain(table: torch.Tensor, ids: torch.Tensor,
                             pad_id: int, mode: str = "mean"
                             ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the (B, L, D) gather in f32,
    pad positions read as row 0 and masked out, then the masked sum or
    mean (`seq_embedding_pool_xla`'s formula). Ids in [-V, 0) wrap and a
    row holding an id outside [-V, V) is NaN, as JAX's gather gives."""
    mask = ids != pad_id
    ids = torch.where(ids < 0, ids + table.shape[0], ids)
    bad = mask & ((ids < 0) | (ids >= table.shape[0]))
    emb = table[torch.where(mask & ~bad, ids, 0).long()].to(torch.float32)
    summed = (emb * mask[..., None]).sum(dim=1)
    if mode == "mean":
        count = mask.sum(dim=1, keepdim=True).to(torch.float32)
        summed = summed / torch.clamp(count, min=1e-12)
    summed = torch.where(bad.any(dim=1, keepdim=True), float("nan"), summed)
    return summed.to(table.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("embedding_gather")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.recbox_seq_embedding_pool.argtypes = [i, i, vp, vp, vp, i, i, i, i,
                                              i, i, vp]
    lib.recbox_seq_embedding_pool.restype = i
    return lib


def _vec_bytes(d: int, itemsize: int, *ptrs: int) -> int:
    """Bytes a lane loads: the widest of 16, 8, 4, 2 that divides a row and
    both base addresses and still gives 32 lanes work, else the widest that
    divides them."""
    fits = [b for b in (16, 8, 4, 2) if b >= itemsize
            and (d * itemsize) % b == 0 and all(p % b == 0 for p in ptrs)]
    busy = [b for b in fits if d * itemsize // b >= 32]
    return (busy or fits)[0]


def _pool_cuda(table, ids, pad_id, mode):
    dev = table.device
    if not (table.is_cuda and ids.device == dev):
        raise ValueError(f"seq_embedding_pool: table on {dev}, ids on "
                         f"{ids.device}; the kernel takes both on one CUDA "
                         "device")
    if table.dtype not in _DTYPES:
        raise TypeError(f"seq_embedding_pool: table dtype {table.dtype}; the "
                        "kernel takes float32 or bfloat16")
    (v, d), (b, length) = table.shape, ids.shape
    table = table.contiguous()
    ids = ids.to(torch.int32).contiguous()
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    if b == 0 or d == 0:
        return out
    if length == 0:
        return out.zero_()
    vec = _vec_bytes(d, table.element_size(), table.data_ptr(),
                     out.data_ptr())
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.recbox_seq_embedding_pool(
            _DTYPES[table.dtype], vec, table.data_ptr(), ids.data_ptr(),
            out.data_ptr(), b, length, d, v, int(pad_id),
            int(mode == "mean"), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"seq_embedding_pool: launch failed with CUDA "
                           f"error {rc}")
    launches["seq_embedding_pool"] += 1
    return out


def seq_embedding_pool(table: torch.Tensor, ids: torch.Tensor, pad_id: int,
                       mode: str = "mean") -> torch.Tensor:
    """Pooled (B, D) embeddings of the (B, L) ``ids`` in ``table`` (V, D),
    the positions equal to ``pad_id`` left out and never read: their sum
    (``mode='sum'``) or mean (``'mean'``; 0 for a row of pads).

    JAX's ``interpret`` and ``force_pallas`` only choose among its
    implementations of this function; there is one here, so they are not
    taken. As in JAX's gather, an id in [-V, 0) counts from the end and a
    row holding an id outside [-V, V) other than ``pad_id`` comes out NaN;
    unlike JAX's gather, a ``pad_id`` outside [0, V) gives no NaN, since
    pad positions are never read."""
    if mode not in _MODES:
        raise ValueError(f"seq_embedding_pool: mode={mode!r}; expected "
                         f"one of {_MODES}")
    if table.ndim != 2 or ids.ndim != 2:
        raise ValueError(f"seq_embedding_pool: table {tuple(table.shape)}, "
                         f"ids {tuple(ids.shape)}; expected (V, D) and (B, L)")
    if table.device.type == "cpu":
        return seq_embedding_pool_plain(table, ids, pad_id, mode)
    return _pool_cuda(table, ids, pad_id, mode)
