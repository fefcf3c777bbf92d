"""Fused full-softmax cross-entropy ("flash-CE"): kernel B2, its plain
PyTorch versions, the autograd functions.

Port of the TPU kernel `recbox_tpu/ops/pallas/fused_ce.py`
(`fused_softmax_ce` :363, `fused_multinomial_ce` :461). The loss of
``user @ table.T`` against labels over the whole vocabulary, without the
(B, V) logits in device memory:

    loss = sum_i w_i (lse_i - ll_i) / max(sum_i w_i, 1e-12)

with lse the row logsumexp of bf16 products summed in f32 and ll the label
logit, the bf16 x bf16 -> f32 gather-dot (:202). The backward recomputes
p = bf16(exp(x - lse_eff)), lse_eff = lse - log w (a row of weight 0 drops
out exactly: its ``du`` is exactly 0), and takes du = p T and dt = p^T U;
the one-hot corrections use the original-precision ``table[labels]`` and
``user`` (:349-350), added into dT by a sort-based accumulation (repeated
labels in a fixed order: two calls give the same bits), and ``weights`` /
``pos_mask`` get their true cotangents (:351-356, :450-454).

The sweeps (`fused_ce_lse`, `fused_ce_bwd`) run the CUDA kernels
(`csrc/fused_ce.cu` `ce_fwd` + `lse_combine` and `ce_bwd` + `du_reduce`,
built by `ops/_build.py`, launched by the plan of `_plan`: clusters of
blocks over B, a persistent walk over V) for CUDA tensors and their plain
versions (`fused_ce_lse_plain`, `fused_ce_bwd_plain`) for CPU tensors; a
CUDA tensor never reaches a plain version, and a failed build or launch
raises. The
wrapper casts ``table`` to bf16 once per call (zero-padding D to a multiple
of 16) and keeps that copy for the backward, as JAX keeps its residuals.
Unlike the TPU kernel there is no bias column: the kernel masks rows past
B and V by bounds.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from recbox_tpu_torch.ops import _build
from recbox_tpu_torch.utils import tracing

__all__ = ["fused_softmax_ce", "fused_multinomial_ce", "fused_ce_lse",
           "fused_ce_bwd", "fused_ce_lse_plain", "fused_ce_bwd_plain",
           "ce_operands", "launches", "reset_launches"]

# kernel launches on the CUDA path (one per forward sweep, one per
# backward); the plain versions never count
launches = tracing.register("fused_ce.launches",
                            {"fused_ce_fwd": 0, "fused_ce_bwd": 0})

_TILE = 64              # table rows a tile, `NT` in the kernel
_MAX_DEPTH = 128        # the kernel's largest padded D
_MAX_CLUSTER = 4        # blocks a cluster (1, 2 or 4: they split a tile)
_PLAIN_CHUNK = 65536    # vocabulary rows a plain-version step


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# -- operands and plain versions -------------------------------------------------

def ce_operands(user: torch.Tensor, table: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, t): bf16 copies of ``user`` (B, D) and ``table`` (V, D), D
    zero-padded to a multiple of 16 (the kernel's k-step), contiguous."""
    u = user.to(torch.bfloat16)
    t = table.to(torch.bfloat16)
    pad = (-user.shape[1]) % 16
    if pad:
        u, t = F.pad(u, (0, pad)), F.pad(t, (0, pad))
    return u.contiguous(), t.contiguous()


def fused_ce_lse_plain(u: torch.Tensor, t: torch.Tensor,
                       chunk: int = _PLAIN_CHUNK) -> torch.Tensor:
    """The forward sweep in plain PyTorch: lse (B,) f32 of u @ t.T from the
    bf16 operands as f32 products, ``chunk`` vocabulary rows at a time."""
    uf = u.float()
    parts = [torch.logsumexp(uf @ t[c:c + chunk].float().T, dim=1)
             for c in range(0, t.shape[0], chunk)]
    return torch.logsumexp(torch.stack(parts), dim=0)


def fused_ce_bwd_plain(u: torch.Tensor, t: torch.Tensor,
                       lse_eff: torch.Tensor, scale: torch.Tensor,
                       d_out: int, chunk: int = _PLAIN_CHUNK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward sweeps in plain PyTorch: p = bf16(exp(x - lse_eff)),
    du = scale · p t (B, d_out), dt = scale · pᵀ u (V, d_out), f32."""
    uf = u.float()
    du = torch.zeros(uf.shape, dtype=torch.float32, device=u.device)
    dt = torch.empty((t.shape[0], d_out), dtype=torch.float32,
                     device=u.device)
    for c in range(0, t.shape[0], chunk):
        tc = t[c:c + chunk].float()
        p = torch.exp(uf @ tc.T - lse_eff[:, None]).to(torch.bfloat16).float()
        du += p @ tc
        dt[c:c + chunk] = (p.T @ uf)[:, :d_out] * scale
    return du[:, :d_out] * scale, dt


# -- the CUDA path --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("fused_ce")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.recbox_fused_ce_lse.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                        i, vp]
    lib.recbox_fused_ce_lse.restype = i
    lib.recbox_fused_ce_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i,
                                        i, i, i, i, i, vp]
    lib.recbox_fused_ce_bwd.restype = i
    lib.recbox_fused_ce_max_clusters.argtypes = [i, i, i]
    lib.recbox_fused_ce_max_clusters.restype = i
    return lib


class CePlan(NamedTuple):
    """How the kernel covers a (B, V) problem: clusters of ``cluster``
    blocks, each block ``rows`` rows of u; ``passes`` launches of cluster ×
    rows rows each; ``clusters`` clusters, cluster k walking the 64-row
    table tiles [k · per, min(tiles, (k + 1) · per))."""
    cluster: int
    rows: int
    passes: int
    clusters: int
    per: int


def _plan(b: int, v: int, dp: int, sms: int) -> CePlan:
    """The kernel's plan for B rows, V table rows and padded depth dp on a
    card of ``sms`` SMs: 256 rows a block at dp <= 64 (`Ce<64>::R`), 128
    above; as many blocks a cluster as B needs, rounded up to 1, 2 or 4
    (each block sums a 64 / cluster-row share of every tile's dT); floor(sms
    / cluster) clusters, none without tiles."""
    rows = 256 if dp <= 64 else 128
    need = min(_MAX_CLUSTER, -(-b // rows))
    cluster = 1 << (need - 1).bit_length()
    passes = -(-b // (cluster * rows))
    tiles = -(-v // _TILE)
    clusters = max(1, min(tiles, sms // cluster))
    per = -(-tiles // clusters)
    return CePlan(cluster, rows, passes, -(-tiles // per), per)


@functools.lru_cache(maxsize=None)
def _cluster_sms(index: int, dp: int, cluster: int) -> int:
    """The SMs that clusters of ``cluster`` blocks fill on card ``index``:
    the SM count, or fewer where the card runs fewer such clusters of the
    kernel at once (`recbox_fused_ce_max_clusters`, the smaller of its two
    directions)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    lib = _kernel_lib()
    with torch.cuda.device(index):
        most = min(lib.recbox_fused_ce_max_clusters(cluster, dp, bwd)
                   for bwd in (0, 1))
    if most <= 0:
        raise RuntimeError(f"fused_ce: cluster occupancy query failed "
                           f"({most})")
    return min(sms, most * cluster)


def _device_plan(b: int, v: int, dp: int, dev: torch.device) -> CePlan:
    cluster = _plan(b, v, dp, 1).cluster          # does not depend on sms
    return _plan(b, v, dp, _cluster_sms(dev.index, dp, cluster))


def _check_cuda(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if not all(x.is_cuda and x.device == dev for x in tensors):
        raise ValueError("fused_ce: the kernel takes its operands on one "
                         "CUDA device")
    for x in tensors:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("fused_ce: operands must be contiguous and "
                             "16-byte aligned")
    return dev


def _lse_cuda(u: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    dev = _check_cuda(u, t)
    (b, dp), v = u.shape, t.shape[0]
    plan = _device_plan(b, v, dp, dev)
    m_part = torch.empty((plan.clusters, b), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    lse = torch.empty(b, dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.recbox_fused_ce_lse(
            u.data_ptr(), t.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            lse.data_ptr(), b, v, dp, plan.cluster, plan.passes,
            plan.clusters, plan.per, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ce forward: launch failed with CUDA "
                           f"error {rc}")
    launches["fused_ce_fwd"] += 1
    return lse


def _bwd_cuda(u, t, lse_eff, scale, d_out):
    lse_eff = lse_eff.to(torch.float32).contiguous()
    scale = scale.to(torch.float32).reshape(()).contiguous()
    dev = _check_cuda(u, t, lse_eff, scale)
    (b, dp), v = u.shape, t.shape[0]
    plan = _device_plan(b, v, dp, dev)
    du_part = torch.empty((plan.clusters, b, d_out), dtype=torch.float32,
                          device=dev)
    du = torch.empty((b, d_out), dtype=torch.float32, device=dev)
    dt = torch.empty((v, d_out), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.recbox_fused_ce_bwd(
            u.data_ptr(), t.data_ptr(), lse_eff.data_ptr(), scale.data_ptr(),
            du_part.data_ptr(), du.data_ptr(), dt.data_ptr(), b, v, dp, d_out,
            plan.cluster, plan.passes, plan.clusters, plan.per,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ce backward: launch failed with CUDA "
                           f"error {rc}")
    launches["fused_ce_bwd"] += 1
    return du, dt


def _check_operands(u: torch.Tensor, t: torch.Tensor) -> None:
    if u.dtype != torch.bfloat16 or t.dtype != torch.bfloat16 \
            or u.ndim != 2 or t.ndim != 2 or u.shape[1] != t.shape[1] \
            or u.shape[1] % 16:
        raise ValueError(f"fused_ce: operands {u.dtype} {tuple(u.shape)} "
                         f"and {t.dtype} {tuple(t.shape)}; expected bf16 "
                         "(B, Dp) and (V, Dp), Dp a multiple of 16")
    if u.device.type != "cpu" and u.shape[1] > _MAX_DEPTH:
        raise ValueError(f"fused_ce: the kernel takes D <= {_MAX_DEPTH}, "
                         f"got a padded depth of {u.shape[1]}")


def fused_ce_lse(u: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Forward sweep over the `ce_operands`: lse (B,) f32. The kernel on a
    CUDA tensor, the plain version on a CPU one."""
    _check_operands(u, t)
    if u.device.type == "cpu":
        return fused_ce_lse_plain(u, t)
    return _lse_cuda(u, t)


def fused_ce_bwd(u: torch.Tensor, t: torch.Tensor, lse_eff: torch.Tensor,
                 scale: torch.Tensor, d_out: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward sweeps over the `ce_operands`: (scale · p t, scale · pᵀ u)
    cut to ``d_out`` columns, f32. The kernel on a CUDA tensor, the plain
    versions on a CPU one."""
    _check_operands(u, t)
    if u.device.type == "cpu":
        return fused_ce_bwd_plain(u, t, lse_eff, scale, d_out)
    return _bwd_cuda(u, t, lse_eff, scale, d_out)


# -- the autograd functions -------------------------------------------------------

def _gather_dot(u: torch.Tensor, t: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """u_i · t[ids_i...] from the bf16 operands, products and sum in f32
    (exact products: bf16 × bf16 fits f32)."""
    rows = t[ids].float()                                  # (B, [H,] Dp)
    uf = u.float()
    if ids.ndim == 2:
        uf = uf[:, None, :]
    return torch.sum(uf * rows, dim=-1)


def _add_rows(dt: torch.Tensor, ids: torch.Tensor,
              rows: torch.Tensor) -> None:
    """dt[ids] += rows, repeated ids in a fixed order, so that two calls
    give the same bits: on the card a sort-based ``index_put_`` (CUDA's
    ``index_add_`` adds by atomics in no fixed order), on the CPU
    ``index_add_`` (there ``index_put_``'s accumulation is the unordered
    one)."""
    if dt.is_cuda:
        dt.index_put_((ids,), rows, accumulate=True)
    else:
        dt.index_add_(0, ids, rows)


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, user, table, labels, weights):
        u, t = ce_operands(user, table)
        lse = fused_ce_lse(u, t)
        lbl = labels.to(torch.int64)
        a = lse - _gather_dot(u, t, lbl)
        w = weights.to(torch.float32)
        sw = torch.clamp(torch.sum(w), min=1e-12)
        loss = torch.sum(w * a) / sw
        ctx.save_for_backward(user, table, lbl, weights, lse, a, u, t)
        return loss

    @staticmethod
    def backward(ctx, g):
        user, table, lbl, weights, lse, a, u, t = ctx.saved_tensors
        d = user.shape[1]
        w = weights.to(torch.float32)
        sw = torch.clamp(torch.sum(w), min=1e-12)
        scale = (g / sw).to(torch.float32)
        # p_w = exp(x - (lse - log w)) = w · p: a row of weight 0 is exactly 0
        du, dt = fused_ce_bwd(u, t, lse - torch.log(w), scale, d)
        ws = (w * scale)[:, None]
        du = du - ws * table[lbl].to(torch.float32)
        _add_rows(dt, lbl, -ws * user.to(torch.float32))
        dw = None
        if ctx.needs_input_grad[3]:
            # L = sum(w a) / sum(w) -> dL/dw_i = (a_i - L) / sum(w)
            loss = torch.sum(w * a) / sw
            dw = (g * (a - loss) / sw).to(weights.dtype)
        return du.to(user.dtype), dt.to(table.dtype), None, dw


class _FusedMCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, user, table, pos_ids, pos_mask):
        u, t = ce_operands(user, table)
        lse = fused_ce_lse(u, t)
        ids = pos_ids.to(torch.int64)
        mm = pos_mask.to(torch.float32)
        ll = _gather_dot(u, t, ids)                              # (B, H)
        n = torch.sum(mm, dim=1)
        loss = torch.sum(n * lse - torch.sum(mm * ll, dim=1)) / user.shape[0]
        ctx.save_for_backward(user, table, ids, pos_mask, lse, ll, u, t)
        return loss

    @staticmethod
    def backward(ctx, g):
        user, table, ids, pos_mask, lse, ll, u, t = ctx.saved_tensors
        b, d = user.shape
        mm = pos_mask.to(torch.float32)
        scale = (g / b).to(torch.float32)
        # dlogits = n_i p - y: the positive count folds into lse like a weight
        du, dt = fused_ce_bwd(u, t, lse - torch.log(torch.sum(mm, dim=1)),
                              scale, d)
        tg = table[ids].to(torch.float32)                     # (B, H, D)
        du = du - scale * torch.einsum("bh,bhd->bd", mm, tg)
        add = scale * mm[:, :, None] * user.to(torch.float32)[:, None, :]
        _add_rows(dt, ids.reshape(-1), -add.reshape(-1, d))
        dm = None
        if ctx.needs_input_grad[3]:
            # dL/dm_ih = (lse_i - ll_ih) / B
            dm = (g * (lse[:, None] - ll) / b).to(pos_mask.dtype)
        return du.to(user.dtype), dt.to(table.dtype), None, dm


def _check_inputs(user, table, ids, name):
    if user.ndim != 2 or table.ndim != 2 or user.shape[1] != table.shape[1]:
        raise ValueError(f"{name}: user {tuple(user.shape)} vs table "
                         f"{tuple(table.shape)}")
    if ids.shape[0] != user.shape[0]:
        raise ValueError(f"{name}: {ids.shape[0]} id rows for "
                         f"{user.shape[0]} user rows")
    if table.device != user.device:
        raise ValueError(f"{name}: user on {user.device}, table on "
                         f"{table.device}")


def fused_softmax_ce(user: torch.Tensor, table: torch.Tensor,
                     labels: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted-mean CE of ``user @ table.T`` against ``labels``; the
    logits never exist in device memory.

    user (B, D) and table (V, D) any float dtype (bf16 products, f32 sums);
    labels (B,) int in [0, V); weights optional (B,) non-negative, loss =
    sum(w (lse - label logit)) / sum(w); a row of w = 0 is an exact no-op in
    the loss and the gradients. None = the plain mean (`full_softmax_loss`
    over bf16 logits). Differentiable in ``user``, ``table`` and
    ``weights``. Single-device op."""
    _check_inputs(user, table, labels, "fused_softmax_ce")
    if weights is None:
        weights = torch.ones(user.shape[0], dtype=torch.float32,
                             device=user.device)
    return _FusedCE.apply(user, table, labels, weights)


def fused_multinomial_ce(user: torch.Tensor, table: torch.Tensor,
                         pos_ids: torch.Tensor,
                         pos_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Multinomial log-likelihood over the full vocabulary (the VAE decoder
    likelihood): mean_i [n_i lse_i - sum_h mask_ih (u_i · t[pos_ih])],
    n_i = sum_h mask_ih. pos_ids (B, H) int, pos_mask optional (B, H)
    (None = all valid); masked slots and empty rows are exact no-ops.
    Differentiable in ``user``, ``table`` and ``pos_mask``."""
    _check_inputs(user, table, pos_ids, "fused_multinomial_ce")
    if pos_mask is None:
        pos_mask = torch.ones(pos_ids.shape, dtype=torch.float32,
                              device=user.device)
    return _FusedMCE.apply(user, table, pos_ids, pos_mask.to(torch.float32))
