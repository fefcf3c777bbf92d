"""Fused row-wise AdaGrad update of a packed table: kernel B1, its plain
PyTorch version, the wrapper.

Port of the TPU kernel `recbox_tpu/ops/pallas/packed_delta.py`
(`fused_adagrad_delta` :90) and of the scatter that consumes its operand
(`pack.at[ids].add`, `recbox_tpu/training/packed.py:649`). For every
gathered row i with per-slot row gradients g_s (N, d_s):

    g2_s    = mean(g_s²)
    delta_s = -lr · g_s / (sqrt(G[:, acc_s] + g2_s) + eps)

in f32, and ``pack[ids] += [delta_0..K | g2_0..K | 0]``. A duplicate id adds
one update per occurrence, each from the pre-step accumulator plus its own
g² (per-example AdaGrad, `packed.py:27-32`).

`packed_adagrad_update_` runs the CUDA kernel (`csrc/packed_delta.cu`,
built by `ops/_build.py`) for CUDA tensors, updating the pack in place
without ever writing the (N, store_w) operand; for CPU tensors it runs
`packed_adagrad_update_plain_`, which builds the operand with
`fused_adagrad_delta_plain` (the JAX kernel's function) and applies it with
``index_add_``. A CUDA tensor never reaches the plain version; a failed
build or launch raises. ``lr`` is a runtime scalar, so a changed learning
rate needs no rebuild.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from recbox_tpu_torch.ops import _build

__all__ = ["fused_adagrad_delta_plain", "packed_adagrad_update_",
           "packed_adagrad_update_plain_", "launches", "reset_launches"]

# kernel launches on the CUDA path; the plain version never counts
launches = {"packed_adagrad_update": 0}

_GRAD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SLOTS = 8


def reset_launches() -> None:
    launches["packed_adagrad_update"] = 0


def fused_adagrad_delta_plain(G: torch.Tensor, grads: Sequence[torch.Tensor],
                              lr: float, *, dims: Sequence[int],
                              acc_cols: Sequence[int], used: int,
                              store_w: int, eps: float) -> torch.Tensor:
    """The (N, store_w) f32 scatter operand ``[delta_0..K | g2_0..K | 0]``
    of the JAX kernel, in its op order."""
    deltas, g2s = [], []
    for d, acc, g in zip(dims, acc_cols, grads):
        g = g.to(torch.float32).reshape(-1, d)
        g2 = torch.mean(torch.square(g), dim=-1, keepdim=True)
        vp = G[:, acc:acc + 1]
        deltas.append(-lr * g / (torch.sqrt(vp + g2) + eps))
        g2s.append(g2)
    parts = deltas + g2s
    if used < store_w:
        parts.append(torch.zeros((G.shape[0], store_w - used),
                                 dtype=torch.float32, device=G.device))
    return torch.cat(parts, dim=1)


def packed_adagrad_update_plain_(pack: torch.Tensor, ids: torch.Tensor,
                                 G: torch.Tensor,
                                 grads: Sequence[torch.Tensor], lr: float, *,
                                 dims: Sequence[int],
                                 acc_cols: Sequence[int], used: int,
                                 eps: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the operand, then
    ``pack.index_add_(0, ids, operand)``."""
    upd = fused_adagrad_delta_plain(G, grads, lr, dims=dims,
                                    acc_cols=acc_cols, used=used,
                                    store_w=pack.shape[1], eps=eps)
    return pack.index_add_(0, ids, upd)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("packed_delta")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.recbox_packed_adagrad_update.argtypes = [
        i, vp, ctypes.c_longlong, i, vp, vp, i, i, i, vp, vp, vp, vp, i, f,
        f, vp]
    lib.recbox_packed_adagrad_update.restype = i
    return lib


def _check_args(pack, ids, G, grads, dims, acc_cols, used):
    if pack.dtype != torch.float32 or pack.ndim != 2:
        raise TypeError(f"packed_adagrad_update_: pack {pack.dtype} "
                        f"{tuple(pack.shape)}; expected a 2-D float32 pack")
    n = ids.shape[0]
    if ids.ndim != 1 or G.ndim != 2 or G.shape[0] != n \
            or G.dtype != torch.float32:
        raise ValueError(f"packed_adagrad_update_: ids {tuple(ids.shape)}, "
                         f"G {G.dtype} {tuple(G.shape)}")
    if not 0 < len(dims) <= _MAX_SLOTS or len(grads) != len(dims) \
            or len(acc_cols) != len(dims):
        raise ValueError(f"packed_adagrad_update_: {len(grads)} grads, "
                         f"{len(dims)} dims, {len(acc_cols)} acc_cols; "
                         f"1..{_MAX_SLOTS} slots")
    if used != sum(dims) + len(dims) or used > pack.shape[1]:
        raise ValueError(f"packed_adagrad_update_: used={used} for dims "
                         f"{tuple(dims)} in a {pack.shape[1]}-wide pack; "
                         "the layout is [values | one g2 per slot]")
    for d, acc, g in zip(dims, acc_cols, grads):
        if g.numel() != n * d or not 0 <= acc < G.shape[1]:
            raise ValueError(f"packed_adagrad_update_: a ({n}, {d}) slot "
                             f"got grads {tuple(g.shape)}, acc col {acc}")


def _update_cuda(pack, ids, G, grads, lr, dims, acc_cols, used, eps):
    dev = pack.device
    tensors = [ids, G, *grads]
    if not (pack.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError("packed_adagrad_update_: the kernel takes the pack, "
                         "ids, G and grads on one CUDA device")
    dtypes = {g.dtype for g in grads}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _GRAD_DTYPES:
        raise TypeError(f"packed_adagrad_update_: grads {sorted(map(str, dtypes))}; "
                        "the kernel takes one of float32 or bfloat16 for all")
    if not pack.is_contiguous():
        raise ValueError("packed_adagrad_update_: the pack must be "
                         "contiguous (it is updated in place)")
    n = ids.shape[0]
    if n == 0:
        return pack
    ids = ids.to(torch.int32).contiguous()
    G = G.contiguous()
    grads = [g.reshape(n, d).contiguous() for g, d in zip(grads, dims)]
    cols, col = [], 0
    for d in dims:
        cols.append(col)
        col += d
    k = len(dims)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.recbox_packed_adagrad_update(
            _GRAD_DTYPES[grads[0].dtype], pack.data_ptr(), pack.shape[0],
            pack.shape[1], ids.data_ptr(), G.data_ptr(), G.shape[1], n, k,
            (ctypes.c_void_p * k)(*[g.data_ptr() for g in grads]),
            (ctypes.c_int * k)(*dims), (ctypes.c_int * k)(*cols),
            (ctypes.c_int * k)(*acc_cols), col, float(lr), float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packed_adagrad_update_: launch failed with CUDA "
                           f"error {rc}")
    launches["packed_adagrad_update"] += 1
    return pack


def packed_adagrad_update_(pack: torch.Tensor, ids: torch.Tensor,
                           G: torch.Tensor, grads: Sequence[torch.Tensor],
                           lr: float, *, dims: Sequence[int],
                           acc_cols: Sequence[int], used: int,
                           eps: float) -> torch.Tensor:
    """Add the row-wise AdaGrad update of the rows ``ids`` into ``pack``
    (P, W) float32, in place, and return it.

    G (N, W') float32: the pack rows gathered at ``ids`` before the step
    (accumulators at ``acc_cols``). grads: per slot a (N, d_s) row gradient
    in bf16 or f32, slot s's values at pack columns sum(dims[:s]) onward,
    its g² at column sum(dims) + s; ``used`` = sum(dims) + len(dims)."""
    _check_args(pack, ids, G, grads, dims, acc_cols, used)
    if pack.device.type == "cpu":
        return packed_adagrad_update_plain_(pack, ids, G, grads, lr,
                                            dims=dims, acc_cols=acc_cols,
                                            used=used, eps=eps)
    return _update_cuda(pack, ids, G, grads, lr, dims, acc_cols, used, eps)
