"""Attention blocks: DIN's target attention and the transformer blocks of
the sequential models.

Counterpart of `recbox_tpu/nn/attention.py` `TargetAttention` (:36-59),
`PositionalEmbedding` (:62-70), `TransformerEncoder` (:73-127),
`CapsuleNetwork` and `MultiInterestSA` (:130-189). The
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

from recbox_tpu_torch.nn.core import _TRUNC_STD, MLP, Dropout, xavier_normal_
from recbox_tpu_torch.nn.fixed_draws import jax_normal

__all__ = ["PositionalEmbedding", "TargetAttention", "TransformerEncoder",
           "CapsuleNetwork", "MultiInterestSA", "LayerNorm", "dense",
           "lecun_normal_"]

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


class CapsuleNetwork(nn.Module):
    """MIND's behaviour-to-interest dynamic routing, (B, L, D) → (B, K, D).

    The routing logits start from JAX's fixed draw ``normal(PRNGKey(17),
    (1, K, L))`` (`nn.fixed_draws.jax_normal`, a numpy copy), shared by
    the batch: zero logits would keep the K capsules equal forever.
    ``routing_rounds`` rounds of squash(softmax-routing) with one bilinear
    map ``bilinear`` (D, D, flax's layout) for every capsule; the logits'
    update reads the mapped history without its gradient. A padded
    behaviour's routing weight is zeroed after the softmax over K."""

    def __init__(self, dim: int, interest_num: int = 4,
                 routing_rounds: int = 3,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.interest_num, self.routing_rounds = interest_num, routing_rounds
        self.bilinear = nn.Parameter(torch.empty(dim, dim, device=device))
        xavier_normal_(self.bilinear, generator)
        self._draws = {}

    def routing_logits(self, length: int, device) -> torch.Tensor:
        """The (1, K, L) initial logits on ``device`` (cached: a captured
        step reads the tensor its warm-up made)."""
        key = (length, str(device))
        if key not in self._draws:
            self._draws[key] = torch.from_numpy(jax_normal(
                17, (1, self.interest_num, length))).to(device)
        return self._draws[key]

    @staticmethod
    def squash(v: torch.Tensor) -> torch.Tensor:
        n2 = torch.sum(v * v, dim=-1, keepdim=True)
        return (n2 / (1.0 + n2)) * v * torch.rsqrt(n2 + 1e-9)

    def forward(self, history: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        b, length, dim = history.shape
        u = torch.einsum("bld,de->ble", history, self.bilinear)
        logits = self.routing_logits(length, u.device).to(u.dtype).expand(
            b, self.interest_num, length)
        keep = mask[:, None, :].to(u.dtype)
        u_fixed = u.detach()
        caps = u.new_zeros(b, self.interest_num, dim)
        for _ in range(self.routing_rounds):
            w = torch.softmax(logits, dim=1) * keep
            caps = self.squash(torch.einsum("bkl,bld->bkd", w, u))
            logits = logits + torch.einsum("bkd,bld->bkl", caps, u_fixed)
        return caps


class MultiInterestSA(nn.Module):
    """ComiRec's self-attentive extractor, (B, L, D) → (B, K, D):
    ``Dense_1(tanh(Dense_0(h)))`` (bias-free, flax's names) gives K
    attention heads, −1e9 on padded positions, a softmax over L, then the
    heads' weighted sums of the history."""

    def __init__(self, dim: int, interest_num: int = 4,
                 hidden_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        hidden = hidden_dim or dim * 4
        self.Dense_0 = dense(dim, hidden, generator, device, bias=False)
        self.Dense_1 = dense(hidden, interest_num, generator, device,
                             bias=False)

    def forward(self, history: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        att = self.Dense_1(torch.tanh(self.Dense_0(history)))    # (B, L, K)
        att = att + torch.where(mask, 0.0, NEG_INF)[..., None]
        att = torch.softmax(att, dim=1)
        return torch.einsum("blk,bld->bkd", att, history)
