"""Core NN blocks: MLP, BatchNorm, FM, first-order term, activations,
initializers.

Counterpart of `recbox_tpu/nn/core.py` (`MLP` :69-104, `get_activation`
:54-66, `FactorizationMachine` :107, `LogisticRegression` :122) and of
flax's linen ``Dropout`` and ``BatchNorm``. The MLP carries Linear →
(BatchNorm) → activation → dropout in a compute dtype. `Dice` is not ported
yet (it raises; only the sequence CTR models call it, `ROADMAP.md`, Queue
A: "Ranking zoo remainder").
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MLP", "BatchNorm", "Dropout", "FactorizationMachine",
           "LogisticRegression", "get_activation", "set_dropout_generator",
           "xavier_normal_", "xavier_uniform_"]

# flax's xavier initializers are variance_scaling(1, 'fan_avg', ...); its
# 'truncated_normal' draws N(0, 1) truncated to [-2, 2] and divides the
# std by that distribution's std, .87962566103423978
_TRUNC_STD = .87962566103423978


def _flax_fans(shape) -> tuple:
    """(fan_in, fan_out) of a flax kernel of ``shape``: the last two axes
    are (in, out), the leading ones a receptive field that multiplies
    both (flax's ``_compute_fans``)."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_normal_(t: torch.Tensor, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """flax `xavier_normal()`: truncated normal at fan_avg variance.

    fan_avg = (rows + cols) / 2 of a 2-D tensor, which is the same for a
    flax (in, out) kernel and the transposed torch (out, in) weight; a
    tensor of more axes is taken in flax's layout (`_flax_fans`)."""
    std = math.sqrt(2.0 / sum(_flax_fans(tuple(t.shape)))) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def xavier_uniform_(t: torch.Tensor, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """flax `xavier_uniform()`: uniform at fan_avg variance (torch's own
    xavier_uniform_ computes the same bound)."""
    with torch.no_grad():
        return nn.init.xavier_uniform_(t, generator=generator)


class Dropout(nn.Module):
    """flax's linen ``Dropout``: keep each element with probability 1 - p
    and scale the kept ones by 1 / (1 - p); a no-op in eval mode or at
    p = 0.

    The keep-mask is drawn from the module's own ``generator``, never from
    torch's global one: `Trainer.init` hands every dropout of its model a
    generator seeded from ``TrainerConfig.seed`` (`set_dropout_generator`),
    so a run is fixed by its seed. Drawing without one raises."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"Dropout: p={p} is not in [0, 1]")
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError(
                "Dropout in training mode draws from its own generator and "
                "has none: Trainer.init hands one out, or call "
                "set_dropout_generator(model, generator)")
        keep_prob = 1.0 - self.p
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def set_dropout_generator(module: nn.Module,
                          generator: torch.Generator) -> None:
    """Give every `Dropout` under ``module`` the generator ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


_ACTIVATIONS: dict = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": F.leaky_relu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "elu": F.elu,
    "silu": F.silu,
    "swish": F.silu,
    "identity": lambda x: x,
    "linear": lambda x: x,
    "none": lambda x: x,
}


def get_activation(act: Union[str, Callable, None]) -> Callable:
    """String registry of activations, as in the JAX package."""
    if act is None:
        return lambda x: x
    if callable(act):
        return act
    key = act.lower()
    if key == "dice":
        raise ValueError("Dice is stateful and not ported yet (ROADMAP.md, "
                         "Queue A: \"Ranking zoo remainder\")")
    if key not in _ACTIVATIONS:
        raise NotImplementedError(f"activation={act}")
    return _ACTIVATIONS[key]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis, with its defaults
    (momentum 0.99, epsilon 1e-5, learned ``scale`` and ``bias``).

    In training mode it normalizes by the batch's mean and biased variance,
    E[x²] − E[x]² clipped at 0 (flax's fast variance), and moves the
    running statistics ``mean`` / ``var`` (buffers, flax's ``batch_stats``
    names) as ``r = momentum · r + (1 − momentum) · batch``; in eval mode it
    normalizes by them. Statistics are f32 and the output is the
    promotion of the input's dtype and f32, as flax's without ``dtype=``.
    (``torch.nn.BatchNorm1d`` keeps an unbiased running variance and
    weighs the new batch by its ``momentum``: it would drift from JAX's
    statistics at the first step.)"""

    def __init__(self, dim: int, momentum: float = 0.99, eps: float = 1e-5,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(xf.ndim - 1))
            mean = torch.mean(xf, dim=axes)
            var = torch.clamp(torch.mean(torch.square(xf), dim=axes)
                              - torch.square(mean), min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean.detach())
                self.var.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * var.detach())
        else:
            mean, var = self.mean, self.var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class MLP(nn.Module):
    """[Linear → (BatchNorm) → act → (dropout)]* → optional ``output_dim``
    head.

    Layer ``i`` is ``dense[i]`` and its norm ``bn[i]``, the counterparts of
    flax's ``Dense_i`` and ``BatchNorm_i`` (`interop.from_jax_params` maps
    one onto the other). Weights are flax's xavier_normal draw, biases
    zero. With ``dtype`` bfloat16 each layer casts its input, weight and
    bias to bf16, as flax's ``Dense(dtype=)`` does; the parameters stay
    float32, and a BatchNorm's output is f32 (flax promotes it).
    """

    def __init__(self, in_dim: int, hidden_units: Sequence[int],
                 activation: Union[str, Sequence[str]] = "relu",
                 output_dim: Optional[int] = None,
                 dropout: Union[float, Sequence[float]] = 0.0,
                 batch_norm: bool = False, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.dtype = dtype
        n = len(hidden_units)
        acts = [activation] * n if isinstance(activation, str) \
            else list(activation)
        drops = [dropout] * n if isinstance(dropout, (int, float)) \
            else list(dropout)
        self._acts = [get_activation(a) for a in acts]
        self.drop = nn.ModuleList([Dropout(p) for p in drops])
        self.bn = nn.ModuleList(
            [BatchNorm(u, device=device) for u in hidden_units]
            if batch_norm else [])
        widths = list(hidden_units) + \
            ([output_dim] if output_dim is not None else [])
        self.dense = nn.ModuleList()
        for units in widths:
            lin = nn.Linear(in_dim, units, bias=use_bias, device=device)
            xavier_normal_(lin.weight, generator)
            if use_bias:
                nn.init.zeros_(lin.bias)
            self.dense.append(lin)
            in_dim = units
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self._acts)
        for i, lin in enumerate(self.dense):
            bias = None if lin.bias is None else lin.bias.to(self.dtype)
            x = F.linear(x.to(self.dtype), lin.weight.to(self.dtype), bias)
            if i < n:
                if self.bn:
                    x = self.bn[i](x)
                x = self.drop[i](self._acts[i](x))
        return x


class FactorizationMachine(nn.Module):
    """Second-order FM over stacked field embeddings (B, F, D) → (B, 1):
    0.5 · (sum² − sum of squares) summed over D."""

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        sum_sq = torch.square(torch.sum(field_emb, dim=1))
        sq_sum = torch.sum(torch.square(field_emb), dim=1)
        return 0.5 * torch.sum(sum_sq - sq_sum, dim=-1, keepdim=True)


class LogisticRegression(nn.Module):
    """First-order term → (B, 1): over stacked (B, F, 1) dim-1 lookups their
    sum, over a flat (B, K) input a bias-free ``Dense_0`` (K → 1, flax's
    xavier_normal; give ``in_dim`` = K), plus a global ``bias`` (zeros)
    unless ``use_bias`` is False."""

    def __init__(self, in_dim: Optional[int] = None, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if in_dim is not None:
            self.Dense_0 = nn.Linear(in_dim, 1, bias=False, device=device)
            xavier_normal_(self.Dense_0.weight, generator)
        self.bias = nn.Parameter(torch.zeros(1, device=device)) \
            if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 3:
            out = torch.sum(x, dim=(1, 2))[:, None]
        elif hasattr(self, "Dense_0"):
            out = self.Dense_0(x)
        else:
            raise ValueError("LogisticRegression over a flat (B, K) input "
                             "needs in_dim=K at construction")
        return out if self.bias is None else out + self.bias
