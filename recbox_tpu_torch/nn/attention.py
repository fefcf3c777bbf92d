"""Attention blocks: DIN's target attention and the transformer blocks of
the sequential models.

Counterpart of `recbox_tpu/nn/attention.py` `TargetAttention` (:36-59),
`PositionalEmbedding` (:62-70) and `TransformerEncoder` (:73-127). The
target attention scores each position of a behaviour sequence by an MLP
(``MLP_0``) over [seq, t, seq − t, seq · t]; a masked score is 0 without a
softmax and −1e9 with one. The transformer follows recbole's
TransformerEncoder contract: n_layers × [multi-head self-attention + GELU feed-forward], post-LN with
eps 1e-12, an additive attention mask (-1e9 on padded keys, plus -1e9 above
the diagonal when ``causal``). A padded query position sees only masked
keys and gets a uniform softmax, as in JAX; the mask is never -inf, which
would give NaN there. The attention is the einsum/softmax it is in JAX.

With ``dtype=torch.bfloat16`` the projections, the feed-forward and the
attention einsums run in bf16 (parameters stay f32) and the residual adds
and LayerNorms promote back to f32, as flax's ``dtype=`` does. Parameter
names follow the flax tree so `interop.from_jax_params` fills them:
``q<i>``/``k<i>``/``v<i>`` (DenseGeneral to (heads, head_dim), a Linear to
heads·head_dim here), ``o<i>``, ``Dense_<j>`` and ``LayerNorm_<j>``
numbered across layers (flax names unnamed submodules in creation order).
Initialization follows flax: lecun-normal (truncated, fan-in) kernels, zero
biases, LayerNorm scale 1 and bias 0; ``pos_emb`` normal(0.02).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.nn.core import _TRUNC_STD, MLP, Dropout

__all__ = ["PositionalEmbedding", "TargetAttention", "TransformerEncoder",
           "LayerNorm", "dense", "lecun_normal_"]

NEG_INF = -1e9


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """flax ``lecun_normal()`` on a torch (out, in) weight: N(0, 1/fan_in)
    truncated to two standard deviations, fan_in = in."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def dense(d_in: int, d_out: int, generator, device,
          bias: bool = True) -> nn.Linear:
    """A flax ``Dense``: lecun-normal kernel, zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias, device=device)
    lecun_normal_(lin.weight, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics over the last axis, learned
    ``scale`` and ``bias`` (flax's names). ``fast_variance`` computes the
    variance as flax does, E[x²] − E[x]² clipped at 0, where an input far
    from centred rounds it apart from `F.layer_norm`'s two-pass one
    (EulerNet's moduli)."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 device: Optional[Union[str, torch.device]] = None,
                 fast_variance: bool = False):
        super().__init__()
        self.eps, self.fast_variance = eps, fast_variance
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fast_variance:
            return F.layer_norm(x.float(), x.shape[-1:], self.scale,
                                self.bias, self.eps)
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(torch.square(xf).mean(-1, keepdim=True)
                          - torch.square(mean), min=0.0)
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class TargetAttention(nn.Module):
    """DIN-style attention of a target (B, D) over a sequence (B, L, D) →
    (B, D): the score MLP (``MLP_0``, f32, Dice by default) over
    [seq, t, seq − t, seq · t], masked (0, or −1e9 before the optional
    softmax), then the score-weighted sum of the sequence. The Dice
    statistics take every position, padded ones included, as JAX's do."""

    def __init__(self, dim: int, hidden_units: Sequence[int] = (80, 40),
                 activation: str = "dice", use_softmax: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.use_softmax = use_softmax
        self.MLP_0 = MLP(4 * dim, tuple(hidden_units), activation=activation,
                         output_dim=1, generator=generator, device=device)

    def forward(self, target: torch.Tensor, sequence: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = target[:, None, :].expand_as(sequence)
        att_in = torch.cat([sequence, t, sequence - t, sequence * t], dim=-1)
        score = self.MLP_0(att_in)[..., 0]                       # (B, L)
        if mask is not None:
            score = torch.where(mask, score, torch.full_like(
                score, NEG_INF if self.use_softmax else 0.0))
        if self.use_softmax:
            score = torch.softmax(score, dim=-1)
        return torch.einsum("bl,bld->bd", score, sequence)


class PositionalEmbedding(nn.Module):
    """Learned absolute position embedding added to a (B, L, D) sequence."""

    def __init__(self, max_len: int, dim: int,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.pos_emb = nn.Parameter(0.02 * torch.randn(
            max_len, dim, generator=generator, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pos_emb[None, :x.shape[1], :]


class TransformerEncoder(nn.Module):
    """n_layers × [MHA → dropout → LN(x + h) → Dense(4D) → GELU (tanh,
    ``jax.nn.gelu``'s default) → Dense(D) → dropout → LN(x + f)] over
    (B, L, D); ``mask`` (B, L) is True at real positions."""

    def __init__(self, dim: int, n_layers: int = 2, n_heads: int = 2,
                 hidden_dropout: float = 0.2, attn_dropout: float = 0.2,
                 inner_dim_multiple: int = 4, causal: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"hidden dim {dim} must divide into {n_heads} "
                             "heads")
        self.n_layers, self.n_heads = n_layers, n_heads
        self.head_dim = dim // n_heads
        self.causal = causal
        self.dtype = dtype or torch.float32
        g, dev = generator, device
        for i in range(n_layers):
            for name in ("q", "k", "v", "o"):
                self.add_module(f"{name}{i}", dense(dim, dim, g, dev))
            self.add_module(f"Dense_{2 * i}",
                            dense(dim, dim * inner_dim_multiple, g, dev))
            self.add_module(f"Dense_{2 * i + 1}",
                            dense(dim * inner_dim_multiple, dim, g, dev))
            for j in (2 * i, 2 * i + 1):
                self.add_module(f"LayerNorm_{j}",
                                LayerNorm(dim, 1e-12, device=dev))
        self.attn_drop = Dropout(attn_dropout)
        self.hidden_drop = Dropout(hidden_dropout)

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        lin = getattr(self, name)
        return F.linear(x.to(self.dtype), lin.weight.to(self.dtype),
                        lin.bias.to(self.dtype))

    def _attention_bias(self, mask: Optional[torch.Tensor], length: int,
                       device) -> torch.Tensor:
        """The additive (B or 1, 1, L, L) f32 mask: -1e9 on padded keys,
        plus -1e9 above the diagonal when causal."""
        bias = torch.zeros((1, 1, length, length), device=device)
        if mask is not None:
            bias = bias + torch.where(mask, 0.0, NEG_INF)[:, None, None, :]
        if self.causal:
            causal = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                           device=device))
            bias = bias + torch.where(causal, 0.0, NEG_INF)[None, None]
        return bias

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, length, dim = x.shape
        h_, hd = self.n_heads, self.head_dim
        bias = self._attention_bias(mask, length, x.device).to(self.dtype)
        # sqrt(head_dim) rounded to the compute dtype, as jnp computes it
        scale = float(torch.tensor(math.sqrt(hd), dtype=self.dtype))
        for i in range(self.n_layers):
            q = self._dense(f"q{i}", x).reshape(b, length, h_, hd)
            k = self._dense(f"k{i}", x).reshape(b, length, h_, hd)
            v = self._dense(f"v{i}", x).reshape(b, length, h_, hd)
            att = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
            att = self.attn_drop(torch.softmax(att + bias, dim=-1))
            h = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, length,
                                                                dim)
            h = self.hidden_drop(self._dense(f"o{i}", h))
            x = getattr(self, f"LayerNorm_{2 * i}")(x + h)
            f = F.gelu(self._dense(f"Dense_{2 * i}", x), approximate="tanh")
            f = self.hidden_drop(self._dense(f"Dense_{2 * i + 1}", f))
            x = getattr(self, f"LayerNorm_{2 * i + 1}")(x + f)
        return x
