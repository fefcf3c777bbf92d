"""Feature-interaction layers of the CTR models.

Counterpart of `recbox_tpu/nn/interactions.py` (:30-284): every layer works
on stacked field embeddings (B, F, D) or their flat concat (B, F·D) with
batched einsums. Parameters keep the flax names and layouts (``w{i}`` /
``b{i}`` of `CrossNet`, ``dense{i}`` of `CrossNetV2`, ``U{l}`` / ``V{l}`` /
``C{l}`` / ``b{l}`` / ``g{l}`` of `CrossNetMix`, the CIN's ``w{i}`` (h, m,
F), ``w`` of `BilinearInteraction`, the ``q`` / ``k`` / ``v`` / ``res``
projections of `InteractingLayer`), so `interop.from_jax_params` moves a
flax tree over; a flax ``Dense`` is a ``torch.nn.Linear`` of the same name.

Dtypes follow flax's promotion: a layer with f32 parameters and no
``dtype=`` computes in the promotion of its input and its parameters, so
under a bf16 model the crosses, the CIN, SENET, the bilinear products and
the attention run in f32 (the bf16 inputs are cast up exactly first) and
return f32; `InnerProduct` and `HolographicInteraction`'s elementwise
product keep the input's dtype. Initializers are flax's: xavier_normal
where the JAX layer names it (3-D kernels at flax's fans), else a
``Dense``'s lecun_normal, biases zero.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.nn.attention import lecun_normal_
from recbox_tpu_torch.nn.core import xavier_normal_

__all__ = [
    "CrossNet", "CrossNetV2", "CrossNetMix", "CompressedInteractionNet",
    "InnerProduct", "SENET", "BilinearInteraction", "HolographicInteraction",
    "InteractionMachine", "InteractingLayer", "triu_pairs",
]


def _param(shape, generator, device, init="xavier") -> nn.Parameter:
    t = torch.empty(shape, device=device)
    if init == "xavier":
        xavier_normal_(t, generator)
    else:
        nn.init.zeros_(t)
    return nn.Parameter(t)


def _linear(d_in: int, d_out: int, bias: bool, generator, device,
            init: str = "lecun") -> nn.Linear:
    """A flax ``Dense``: lecun_normal kernel (or xavier_normal), zero
    bias."""
    lin = nn.Linear(d_in, d_out, bias=bias, device=device)
    if init == "xavier":
        xavier_normal_(lin.weight, generator)
    else:
        lecun_normal_(lin.weight, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def triu_pairs(n: int, device=None):
    """(i, j) of every pair i < j in ``jnp.triu_indices(n, k=1)``'s
    order."""
    iu, ju = torch.triu_indices(n, n, offset=1, device=device)
    return iu, ju


class CrossNet(nn.Module):
    """DCN cross layers over a flat (B, d) input:
    x_{l+1} = x0 · (x_l · w_l) + b_l + x_l."""

    def __init__(self, dim: int, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"w{i}", _param((dim, 1), generator,
                                                    device))
            self.register_parameter(f"b{i}", _param((dim,), generator,
                                                    device, "zeros"))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x0 = x0.float()
        x = x0
        for i in range(self.num_layers):
            x = x0 * (x @ getattr(self, f"w{i}")) + getattr(self, f"b{i}") + x
        return x


class CrossNetV2(nn.Module):
    """DCNv2 cross layers: x_{l+1} = x0 ⊙ (W_l x_l + b_l) + x_l, each W_l a
    ``dense{i}`` (xavier_normal)."""

    def __init__(self, dim: int, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"dense{i}", _linear(dim, dim, True, generator,
                                                 device, "xavier"))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x0 = x0.float()
        x = x0
        for i in range(self.num_layers):
            x = x0 * getattr(self, f"dense{i}")(x) + x
        return x


class CrossNetMix(nn.Module):
    """DCN-Mix: low-rank cross experts under a softmax gate,
    E_i(x) = x0 ⊙ (U_i tanh(C_i tanh(V_iᵀ x)) + b); out = Σ_i g_i E_i + x."""

    def __init__(self, dim: int, num_layers: int = 3, low_rank: int = 32,
                 num_experts: int = 4,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        e, r, g = num_experts, low_rank, generator
        for l in range(num_layers):
            self.register_parameter(f"U{l}", _param((e, dim, r), g, device))
            self.register_parameter(f"V{l}", _param((e, dim, r), g, device))
            self.register_parameter(f"C{l}", _param((e, r, r), g, device))
            self.register_parameter(f"b{l}", _param((dim,), g, device,
                                                    "zeros"))
            self.register_parameter(f"g{l}", _param((dim, e), g, device))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x0 = x0.float()
        x = x0
        for l in range(self.num_layers):
            U, V, C = (getattr(self, f"{n}{l}") for n in "UVC")
            v_x = torch.tanh(torch.einsum("bd,edr->ber", x, V))
            v_x = torch.tanh(torch.einsum("ber,ers->bes", v_x, C))
            uv_x = torch.einsum("bes,eds->bed", v_x, U)
            expert_out = x0[:, None, :] * (uv_x + getattr(self, f"b{l}"))
            gate = torch.softmax(x @ getattr(self, f"g{l}"), dim=-1)
            x = torch.einsum("bed,be->bd", expert_out, gate) + x
        return x


class CompressedInteractionNet(nn.Module):
    """xDeepFM's CIN over (B, F, D) → (B, 1): X^k = W^k · (X^{k−1} ⊗ X^0)
    along fields as one einsum a layer (kernel ``w{i}`` (h, m, F)), each
    map summed over D, then ``Dense_0`` (xavier_normal) over the concat.
    ``activation`` 'identity' (recbox's CIN) or 'relu' (recbole's)."""

    def __init__(self, num_fields: int, layer_sizes: Sequence[int] = (16, 16),
                 activation: str = "identity",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if activation not in ("identity", "relu"):
            raise ValueError(f"CIN activation={activation!r}")
        self.layer_sizes = tuple(layer_sizes)
        self.activation = activation
        prev = num_fields
        for i, h in enumerate(self.layer_sizes):
            self.register_parameter(f"w{i}", _param((h, prev, num_fields),
                                                    generator, device))
            prev = h
        self.Dense_0 = _linear(sum(self.layer_sizes), 1, True, generator,
                               device, "xavier")

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        x0 = field_emb.float()
        xk = x0
        pooled = []
        for i in range(len(self.layer_sizes)):
            xk = torch.einsum("bmd,bfd,hmf->bhd", xk, x0,
                              getattr(self, f"w{i}"))
            if self.activation == "relu":
                xk = F.relu(xk)
            pooled.append(torch.sum(xk, dim=-1))
        return self.Dense_0(torch.cat(pooled, dim=-1))


class InnerProduct(nn.Module):
    """All pairwise field dot products (B, F(F−1)/2): the upper triangle of
    the (B, F, F) gram matrix, in the input's dtype."""

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        iu, ju = triu_pairs(field_emb.shape[1], field_emb.device)
        gram = torch.einsum("bfd,bgd->bfg", field_emb, field_emb)
        return gram[:, iu, ju]


class SENET(nn.Module):
    """Squeeze-excitation over fields: mean over D, ``Dense_0`` (F → F //
    ratio, at least 1) and ``Dense_1`` (back to F), both bias-free with a
    relu, reweight each field."""

    def __init__(self, num_fields: int, reduction_ratio: int = 3,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        reduced = max(1, num_fields // reduction_ratio)
        self.Dense_0 = _linear(num_fields, reduced, False, generator, device)
        self.Dense_1 = _linear(reduced, num_fields, False, generator, device)

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        z = torch.mean(field_emb, dim=-1).float()
        a = F.relu(self.Dense_1(F.relu(self.Dense_0(z))))
        return field_emb.float() * a[..., None]


class BilinearInteraction(nn.Module):
    """FiBiNET bilinear pairs (v_i W) ⊙ v_j for i < j, flat (B, P·D);
    ``bilinear_type`` 'field_all' (``w`` (D, D)), 'field_each' (F, D, D) or
    'field_interaction' (P, D, D)."""

    def __init__(self, num_fields: int, dim: int,
                 bilinear_type: str = "field_interaction",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        shapes = {"field_all": (dim, dim),
                  "field_each": (num_fields, dim, dim),
                  "field_interaction": (num_fields * (num_fields - 1) // 2,
                                        dim, dim)}
        if bilinear_type not in shapes:
            raise ValueError(bilinear_type)
        self.bilinear_type = bilinear_type
        self.w = _param(shapes[bilinear_type], generator, device)

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        b = field_emb.shape[0]
        x = field_emb.float()
        iu, ju = triu_pairs(x.shape[1], x.device)
        if self.bilinear_type == "field_all":
            left = torch.einsum("bfd,de->bfe", x, self.w)[:, iu]
        elif self.bilinear_type == "field_each":
            left = torch.einsum("bfd,fde->bfe", x, self.w)[:, iu]
        else:
            left = torch.einsum("bpd,pde->bpe", x[:, iu], self.w)
        return (left * x[:, ju]).reshape(b, -1)


class HolographicInteraction(nn.Module):
    """HFM: circular convolution / correlation of field pairs by rFFT (f32),
    or their elementwise product; flat (B, P·D)."""

    def __init__(self, interaction_type: str = "circular_convolution"):
        super().__init__()
        self.interaction_type = interaction_type

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        b, _, d = field_emb.shape
        iu, ju = triu_pairs(field_emb.shape[1], field_emb.device)
        a, c = field_emb[:, iu], field_emb[:, ju]
        if self.interaction_type == "elementwise_product":
            out = a * c
        else:
            fa = torch.fft.rfft(a.float(), dim=-1)
            fc = torch.fft.rfft(c.float(), dim=-1)
            if self.interaction_type == "circular_correlation":
                fa = torch.conj(fa)
            out = torch.fft.irfft(fa * fc, n=d, dim=-1)
        return out.reshape(b, -1)


class InteractionMachine(nn.Module):
    """IM: orders 1..``order`` of the elementary symmetric aggregates over
    fields from power sums (Newton's identities), then ``Dense_0`` →
    (B, 1)."""

    def __init__(self, dim: int, order: int = 2,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if not 1 <= order <= 5:
            raise ValueError("IM supports order 1..5")
        self.order = order
        self.Dense_0 = _linear(dim * order, 1, True, generator, device,
                               "xavier")

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        x = field_emb
        p1 = torch.sum(x, dim=1)
        outs = [p1]
        if self.order >= 2:
            p2 = torch.sum(x ** 2, dim=1)
            outs.append((p1 ** 2 - p2) / 2)
        if self.order >= 3:
            p3 = torch.sum(x ** 3, dim=1)
            outs.append((p1 ** 3 - 3 * p1 * p2 + 2 * p3) / 6)
        if self.order >= 4:
            p4 = torch.sum(x ** 4, dim=1)
            outs.append((p1 ** 4 - 6 * p1 ** 2 * p2 + 3 * p2 ** 2
                         + 8 * p1 * p3 - 6 * p4) / 24)
        if self.order >= 5:
            p5 = torch.sum(x ** 5, dim=1)
            outs.append((p1 ** 5 - 10 * p1 ** 3 * p2 + 20 * p1 ** 2 * p3
                         - 30 * p1 * p4 - 20 * p2 * p3 + 15 * p1 * p2 ** 2
                         + 24 * p5) / 120)
        return self.Dense_0(torch.cat(outs, dim=-1).float())


class InteractingLayer(nn.Module):
    """AutoInt's multi-head self-attention over fields: (B, F, D) →
    (B, F, heads · att_dim), bias-free ``q`` / ``k`` / ``v`` projections
    (flax DenseGeneral to (heads, att_dim)), an unscaled softmax over
    fields, the ``res`` projection added, relu."""

    def __init__(self, dim: int, att_dim: int = 16, num_heads: int = 2,
                 use_residual: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.att_dim, self.num_heads = att_dim, num_heads
        out = att_dim * num_heads
        for name in ("q", "k", "v"):
            self.add_module(name, _linear(dim, out, False, generator,
                                          device))
        self.res = _linear(dim, out, False, generator, device) \
            if use_residual else None

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        x = field_emb.float()
        b, f, _ = x.shape
        h, a = self.num_heads, self.att_dim
        q = self.q(x).reshape(b, f, h, a)
        k = self.k(x).reshape(b, f, h, a)
        v = self.v(x).reshape(b, f, h, a)
        att = torch.softmax(torch.einsum("bfha,bgha->bhfg", q, k), dim=-1)
        out = torch.einsum("bhfg,bgha->bfha", att, v).reshape(b, f, h * a)
        if self.res is not None:
            out = out + self.res(x)
        return F.relu(out)
