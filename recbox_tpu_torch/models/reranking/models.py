"""Listwise rerankers: PRM, DLCM, SetRank, MiDNN, GSF, and their losses.

Counterpart of `recbox_tpu/models/reranking/models.py` (:31-168). A model
maps ``(item_feats (B, N, D), mask (B, N) bool)`` to (B, N) scores; the
losses and `evaluation.rerank.evaluate_rerank` ignore masked slots.
Submodules carry the flax names (``input_proj``, ``pos``, ``encoder``,
``score``, ``GRUCell_0`` with ``ir`` / ``iz`` / ``in`` / ``hr`` / ``hz`` /
``hn``, ``wc``, ``mlp``, ``group_mlp``), so `interop.from_jax_params`
moves a flax tree over. Each model takes ``generator`` and ``device``
(`models.base.init_rng`).

DLCM's GRU is flax's ``GRUCell`` run by ``nn.RNN`` over the whole padded
length: bias on the three input projections and on ``hn`` only, the
recurrent kernels drawn orthogonal. It is written out as a loop over the
list: ``torch.nn.GRU`` carries trainable biases on the r and z recurrent
projections too, which an optimizer would move apart from JAX's model.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.models.base import init_rng
from recbox_tpu_torch.nn.attention import (
    PositionalEmbedding, TransformerEncoder, lecun_normal_,
)
from recbox_tpu_torch.nn.core import MLP

__all__ = ["PRM", "DLCM", "SetRank", "MiDNN", "GSF", "listwise_bce",
           "listwise_softmax_ce"]

Device = Optional[Union[str, torch.device]]


def listwise_bce(scores: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Masked per-item BCE over the valid slots (librerank's logloss);
    a masked slot's score, even NaN or inf, never reaches the sum."""
    labels = labels.to(scores.dtype)
    m = mask.to(scores.dtype)
    per = torch.where(m > 0, F.softplus(scores) - labels * scores,
                      torch.zeros_like(scores))
    return torch.sum(per) / torch.clamp(torch.sum(m), min=1.0)


def listwise_softmax_ce(scores: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Softmax CE over the list against the normalized click distribution
    (masked slots at −1e9)."""
    neg = torch.full_like(scores, -1e9)
    logp = torch.log_softmax(torch.where(mask, scores, neg), dim=-1)
    labels = labels.to(scores.dtype) * mask.to(scores.dtype)
    target = labels / torch.clamp(torch.sum(labels, dim=-1, keepdim=True),
                                  min=1e-9)
    return -torch.mean(torch.sum(target * logp, dim=-1))


def _dense(d_in: int, d_out: int, generator, device,
           bias: bool = True) -> nn.Linear:
    """A flax ``Dense``: lecun_normal kernel, zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias, device=device)
    lecun_normal_(lin.weight, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class _Reranker(nn.Module):
    def __init__(self, generator, device):
        super().__init__()
        self._gen, self._dev = init_rng(generator, device)


class PRM(_Reranker):
    """Personalized re-ranking: ``input_proj`` + position embedding →
    transformer blocks (no causal mask) → per-item ``score``."""

    def __init__(self, in_dim: int, d_model: int = 64, n_layers: int = 2,
                 n_heads: int = 2, max_list_len: int = 50,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(generator, device)
        g, dev = self._gen, self._dev
        self.input_proj = _dense(in_dim, d_model, g, dev)
        self.pos = PositionalEmbedding(max_list_len, d_model, generator=g,
                                       device=dev)
        self.encoder = TransformerEncoder(
            d_model, n_layers=n_layers, n_heads=n_heads,
            hidden_dropout=dropout, attn_dropout=dropout, generator=g,
            device=dev)
        self.score = _dense(d_model, 1, g, dev)

    def forward(self, item_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        x = self.pos(self.input_proj(item_feats))
        return self.score(self.encoder(x, mask=mask))[..., 0]


class _GRUCell(nn.Module):
    """flax ``GRUCell``: r = σ(ir(x) + hr(h)), z = σ(iz(x) + hz(h)),
    n = tanh(in(x) + r · hn(h)), h' = (1 − z) · n + z · h."""

    def __init__(self, in_dim: int, hidden: int, generator, device):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, _dense(in_dim, hidden, generator, device))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            lin = nn.Linear(hidden, hidden, bias=bias, device=device)
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, generator=generator)
            if bias:
                nn.init.zeros_(lin.bias)
            self.add_module(name, lin)
        self.hidden = hidden

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, D) → the (B, L, H) states, from a zero carry over all L
        steps."""
        xr, xz, xn = self.ir(x), self.iz(x), getattr(self, "in")(x)
        h = torch.zeros(x.shape[0], self.hidden, dtype=xr.dtype,
                        device=x.device)
        out = []
        for t in range(x.shape[1]):
            r = torch.sigmoid(xr[:, t] + self.hr(h))
            z = torch.sigmoid(xz[:, t] + self.hz(h))
            n = torch.tanh(xn[:, t] + r * self.hn(h))
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out, dim=1)


class DLCM(_Reranker):
    """Deep listwise context model: a GRU over the list; each item scored
    by its state against tanh(``wc`` · the state at the last valid slot)."""

    def __init__(self, in_dim: int, hidden_size: int = 64,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(generator, device)
        g, dev = self._gen, self._dev
        self.GRUCell_0 = _GRUCell(in_dim, hidden_size, g, dev)
        self.wc = _dense(hidden_size, hidden_size, g, dev, bias=False)

    def forward(self, item_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        h = self.GRUCell_0(item_feats)
        seq_len = torch.sum(mask.to(torch.int64), dim=-1)
        idx = torch.clamp(seq_len - 1, min=0)
        ctx = h[torch.arange(h.shape[0], device=h.device), idx]
        return torch.einsum("blh,bh->bl", h, torch.tanh(self.wc(ctx)))


class SetRank(_Reranker):
    """Permutation-invariant set attention: ``input_proj`` → transformer
    blocks without position embeddings → per-item ``score``."""

    def __init__(self, in_dim: int, d_model: int = 64, n_layers: int = 2,
                 n_heads: int = 2, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(generator, device)
        g, dev = self._gen, self._dev
        self.input_proj = _dense(in_dim, d_model, g, dev)
        self.encoder = TransformerEncoder(
            d_model, n_layers=n_layers, n_heads=n_heads,
            hidden_dropout=dropout, attn_dropout=dropout, generator=g,
            device=dev)
        self.score = _dense(d_model, 1, g, dev)

    def forward(self, item_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        return self.score(self.encoder(self.input_proj(item_feats),
                                       mask=mask))[..., 0]


class MiDNN(_Reranker):
    """miDNN: each item's features beside their min-max normalization over
    the valid slots of its list, under a pointwise ``mlp``. An empty list
    takes 0 for its statistics (no −inf · 0 = NaN)."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int] = (128, 64),
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(generator, device)
        self.mlp = MLP(2 * in_dim, tuple(hidden_units), output_dim=1,
                       dropout=dropout, generator=self._gen, device=self._dev)

    def forward(self, item_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None]
        inf = torch.full_like(item_feats, float("inf"))
        fmax = torch.amax(torch.where(m, item_feats, -inf), dim=1,
                          keepdim=True)
        fmin = torch.amin(torch.where(m, item_feats, inf), dim=1,
                          keepdim=True)
        empty = ~torch.isfinite(fmax)
        zero = torch.zeros_like(fmax)
        fmax = torch.where(empty, zero, fmax)
        fmin = torch.where(empty, zero, fmin)
        denom = torch.clamp(fmax - fmin, min=1e-9)
        global_feat = torch.where(m, (item_feats - fmin) / denom,
                                  torch.zeros_like(item_feats))
        x = torch.cat([item_feats, global_feat], dim=-1)
        return self.mlp(x)[..., 0]


class GSF(_Reranker):
    """Groupwise scoring: a shared ``group_mlp`` scores each circular group
    of ``group_size`` slots starting at every position (padded slots zeroed
    first); an item's score is the mean over the m groups that hold it."""

    def __init__(self, in_dim: int, group_size: int = 3,
                 hidden_units: Sequence[int] = (128, 64),
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(generator, device)
        self.group_size = group_size
        self.group_mlp = MLP(group_size * in_dim, tuple(hidden_units),
                             output_dim=group_size, dropout=dropout,
                             generator=self._gen, device=self._dev)

    def forward(self, item_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        b, n, d = item_feats.shape
        m = self.group_size
        x = item_feats * mask[..., None].to(item_feats.dtype)
        pos = torch.arange(n, device=x.device)
        idx = (pos[:, None] + torch.arange(m, device=x.device)[None]) % n
        per_group = self.group_mlp(x[:, idx].reshape(b, n, m * d))
        # member j of group g is item (g + j) mod n: roll each member's
        # scores back onto its items
        out = sum(torch.roll(per_group[:, :, j], shifts=j, dims=1)
                  for j in range(m))
        return out / m
