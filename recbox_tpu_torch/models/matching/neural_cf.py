"""Neural collaborative filtering: models whose score is a learned f(u, i).

Counterpart of `recbox_tpu/models/matching/neural_cf.py`: `PairScoringModel`
(`forward` scores a batch's (B, S) candidate ids, `full_scores` f(u, ·) over
the whole corpus, recbole's ``full_sort_predict``), `NeuMF`, `ConvNCF`,
`FISM`, `NAIS`, `ENMF` with `enmf_loss`, and `NNCF`. None has towers.

Parameter names are flax's (``emb_gmf_user``, ``mlp``, ``head``,
``conv0``, ``att_hidden``, ``bias_item``, ``h``, ...), so
`interop.from_jax_params` maps a JAX param tree onto them (a flax Conv
kernel (kh, kw, in, out) onto torch's (out, in, kh, kw)). Tables draw
normal(std 1e-4), dense kernels flax's defaults (lecun normal; the heads
xavier normal), biases zeros. Convolutions pad as flax's 'SAME' does.

Batch contract: ``user_id`` (B,), candidate ids ``__item_ids__`` (B, S);
FISM, NAIS and ENMF also read ``hist`` (B, L), item histories padded with
0. Dropout draws from the trainer's generator (`nn.core.Dropout`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import MatchingModel
from recbox_tpu_torch.nn.core import (
    MLP, Dropout, normal_table, xavier_normal_,
)
from recbox_tpu_torch.parallel.mesh import (
    lookup, whole_table, whole_tables,
)

__all__ = ["PairScoringModel", "NeuMF", "ConvNCF", "NAIS", "FISM", "ENMF",
           "NNCF", "enmf_loss"]

Device = Optional[Union[str, torch.device]]


def _table(rows: int, dim: int, generator, device) -> nn.Parameter:
    """A user or item table, row-sharded under a mesh (JAX's
    ``_sharded()``)."""
    return normal_table((rows, dim), 1e-4, generator, device, shard=True)


def _lecun_(w: torch.Tensor, fan_in: int, generator) -> None:
    """flax's default kernel init: truncated normal, variance 1 / fan_in."""
    from recbox_tpu_torch.nn.core import _TRUNC_STD
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def _dense(in_dim: int, out_dim: int, bias: bool, generator, device,
           xavier: bool = False) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim, bias=bias, device=device)
    if xavier:
        xavier_normal_(lin.weight, generator)
    else:
        _lecun_(lin.weight, in_dim, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def _same_pad(size: int, k: int, stride: int):
    """flax 'SAME' padding of one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; under a mesh the rows of a sharded table through
    the exchange, or of its whole copy inside ``full_scores``."""
    return lookup(table, ids.long())


class PairScoringModel(MatchingModel):
    """Base of the f(u, i) scorers: subclasses implement
    ``score(batch, item_ids) -> (B, S)``."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 num_users: int = 0, num_items: int = 0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        self._gen, self._dev = self.init_rng(generator, device)
        self.num_users, self.num_items = int(num_users), int(num_items)

    def score(self, batch, item_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, batch):
        return self.score(batch, batch["__item_ids__"])

    def full_scores(self, batch) -> torch.Tensor:
        """(B, num_items) scores of every item for each user. Under a mesh
        the sharded tables are gathered whole for the call (f(u, i) runs
        replicated layers on every pair, so the logits are this rank's
        rows against every item, a plain tensor)."""
        qi = self.feature_map.query_index
        users = batch[qi] if qi in batch else batch["user_id"]
        ids = torch.arange(self.num_items, device=users.device)
        with whole_tables(self):
            return self.score(batch, ids[None, :].expand(users.shape[0], -1))

    def user_tower(self, batch):
        raise NotImplementedError("pair-scoring models have no user tower")

    def item_tower(self, batch):
        raise NotImplementedError("pair-scoring models have no item tower")


class NeuMF(PairScoringModel):
    """Neural MF: the GMF product ⊕ an MLP over [user, item] embeddings,
    fused by a linear head."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 mlp_hidden_units: Sequence[int] = (128, 64),
                 dropout: float = 0.0, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        d, g, dev = embedding_dim, self._gen, self._dev
        self.emb_gmf_user = _table(self.num_users, d, g, dev)
        self.emb_gmf_item = _table(self.num_items, d, g, dev)
        self.emb_mlp_user = _table(self.num_users, d, g, dev)
        self.emb_mlp_item = _table(self.num_items, d, g, dev)
        self.mlp = MLP(2 * d, mlp_hidden_units, dropout=dropout, generator=g,
                       device=dev)
        self.head = _dense(d + self.mlp.out_dim, 1, False, g, dev,
                           xavier=True)

    def score(self, batch, item_ids):
        u = batch["user_id"]
        gu = _gather(self.emb_gmf_user, u)[:, None]
        gi = _gather(self.emb_gmf_item, item_ids)
        mu = _gather(self.emb_mlp_user, u)[:, None]
        mi = _gather(self.emb_mlp_item, item_ids)
        deep = self.mlp(torch.cat([mu.expand_as(mi), mi], dim=-1))
        return self.head(torch.cat([gu * gi, deep], dim=-1))[..., 0]


class ConvNCF(PairScoringModel):
    """Convolutional NCF: a CNN (2×2 kernels, stride 2, relu) over the
    D × D outer product of the user and item embeddings, summed over space,
    then a linear head."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 channels: Sequence[int] = (16, 16), **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        g, dev = self._gen, self._dev
        self.emb_user = _table(self.num_users, embedding_dim, g, dev)
        self.emb_item = _table(self.num_items, embedding_dim, g, dev)
        self.n_convs = len(channels)
        c_in = 1
        for k, c in enumerate(channels):
            conv = nn.Conv2d(c_in, c, 2, stride=2, device=dev)
            _lecun_(conv.weight, c_in * 4, g)
            nn.init.zeros_(conv.bias)
            setattr(self, f"conv{k}", conv)
            c_in = c
        self.head = _dense(c_in, 1, False, g, dev, xavier=True)

    def score(self, batch, item_ids):
        u = _gather(self.emb_user, batch["user_id"])
        i = _gather(self.emb_item, item_ids)
        b, s, d = i.shape
        x = torch.einsum("bd,bse->bsde", u, i).reshape(b * s, 1, d, d)
        for k in range(self.n_convs):
            ph, pw = (_same_pad(n, 2, 2) for n in x.shape[2:])
            x = F.relu(getattr(self, f"conv{k}")(F.pad(x, (*pw, *ph))))
        return self.head(torch.sum(x, dim=(2, 3))).reshape(b, s)


class _HistoryScorer(PairScoringModel):
    """FISM's and NAIS's history against the candidate: source and target
    tables, an item bias, and the self-exclusion mask (a history item never
    counts as evidence for itself)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 alpha: float = 0.5, split_to: int = 0, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        g, dev = self._gen, self._dev
        self.alpha = alpha
        self.emb_src = _table(self.num_items, embedding_dim, g, dev)
        self.emb_dst = _table(self.num_items, embedding_dim, g, dev)
        self.bias_item = nn.Parameter(torch.zeros(self.num_items,
                                                  device=dev))

    def _history(self, batch, item_ids):
        hist = batch["hist"]
        src = _gather(self.emb_src, hist)                        # (B, L, D)
        dst = _gather(self.emb_dst, item_ids)                    # (B, S, D)
        sim = torch.einsum("bld,bsd->bsl", src, dst)
        valid = (hist != 0)[:, None, :] \
            & ~(hist[:, None, :] == item_ids[:, :, None])
        counts = torch.clamp(valid.sum(-1), min=1).to(sim.dtype)
        return sim, valid, counts


class FISM(_HistoryScorer):
    """Factored item similarity: b_i + |H|^-α Σ_{j∈H} ⟨p_j, q_i⟩."""

    def score(self, batch, item_ids):
        sim, valid, counts = self._history(batch, item_ids)
        agg = torch.sum(torch.where(valid, sim, torch.zeros_like(sim)), -1)
        return agg * torch.pow(counts, -self.alpha) \
            + _gather(self.bias_item, item_ids)


class NAIS(_HistoryScorer):
    """Neural attentive item similarity: FISM with an attention net over
    p_j ⊙ q_i and a β-smoothed softmax (the logits clamped at 60 before
    the exp, as in JAX)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 beta: float = 0.5, attention_dim: int = 32, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        self.beta = beta
        self.att_hidden = _dense(embedding_dim, attention_dim, True,
                                 self._gen, self._dev)
        self.att_out = _dense(attention_dim, 1, False, self._gen, self._dev)

    def score(self, batch, item_ids):
        sim, valid, _ = self._history(batch, item_ids)
        src = _gather(self.emb_src, batch["hist"])
        dst = _gather(self.emb_dst, item_ids)
        prod = src[:, None, :, :] * dst[:, :, None, :]           # (B,S,L,D)
        logits = self.att_out(F.relu(self.att_hidden(prod)))[..., 0]
        w = torch.where(valid, torch.exp(torch.clamp(logits, max=60.0)),
                        torch.zeros_like(logits))
        denom = torch.pow(torch.clamp(w.sum(-1), min=1e-12), self.beta)
        return torch.sum(w * sim, dim=-1) / denom \
            + _gather(self.bias_item, item_ids)


class ENMF(PairScoringModel):
    """Efficient neural MF: the user is the dropout-pooled sum of its
    history's embeddings; score = Σ_d u_d v_d h_d. `enmf_loss` is the
    whole-corpus squared loss, no negative sampling."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 dropout: float = 0.5, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        self.emb_item = _table(self.num_items, embedding_dim, self._gen,
                               self._dev)
        self.h = nn.Parameter(torch.full((embedding_dim, 1), 0.01,
                                         device=self._dev))
        self.drop = Dropout(dropout)

    def user_repr(self, batch) -> torch.Tensor:
        hist = batch["hist"]
        emb = _gather(self.emb_item, hist) \
            * (hist != 0)[..., None].to(self.emb_item.dtype)
        return torch.sum(self.drop(emb), dim=1)

    def score(self, batch, item_ids):
        return torch.einsum("bd,bsd,d->bs", self.user_repr(batch),
                            _gather(self.emb_item, item_ids), self.h[:, 0])

    def all_scores_and_parts(self, batch):
        """(scores of the history items (B, L), user repr, item table, h),
        `enmf_loss`'s inputs."""
        u = self.user_repr(batch)
        v = _gather(self.emb_item, batch["hist"])
        h = self.h[:, 0]
        # the Gram term reads every item: the whole table under a mesh
        return torch.einsum("bd,bld,d->bl", u, v, h), u, \
            whole_table(self.emb_item), h


def enmf_loss(pos_scores, user_repr, item_table, h, hist_mask,
              neg_weight: float = 0.5) -> torch.Tensor:
    """ENMF's whole-corpus squared loss through the Gram trick:
    (Σ_u uuᵀ)·(Σ_i (h⊙v)(h⊙v)ᵀ) for the all-pairs term, O((B + N)·D²)."""
    mask = hist_mask.to(pos_scores.dtype)
    pos_part = torch.sum(((1.0 - neg_weight) * pos_scores * pos_scores
                          - 2.0 * pos_scores) * mask)
    gram_u = torch.einsum("bd,be->de", user_repr, user_repr)
    hv = item_table * h[None, :]
    gram_v = torch.einsum("id,ie->de", hv, hv)
    return (pos_part + neg_weight * torch.sum(gram_u * gram_v)) \
        / pos_scores.shape[0]


class NNCF(PairScoringModel):
    """Neighborhood-enhanced NCF: the GMF product ⊕ the user's item
    neighborhood and the item's user neighborhood, each embedded, passed
    through a 1-D convolution ('SAME', relu) and max-pooled, then an MLP and
    a linear head. ``user_neighbors`` (num_users, K) item ids and
    ``item_neighbors`` (num_items, K) user ids are fixed buffers."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 user_neighbors=None, item_neighbors=None,
                 conv_channels: int = 16, conv_kernel: int = 3,
                 mlp_hidden_units: Sequence[int] = (64, 32),
                 dropout: float = 0.0, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        g, dev, d = self._gen, self._dev, embedding_dim
        self.register_buffer("user_neighbors", torch.as_tensor(
            np.asarray(getattr(user_neighbors, "value", user_neighbors),
                       np.int64), device=dev), persistent=False)
        self.register_buffer("item_neighbors", torch.as_tensor(
            np.asarray(getattr(item_neighbors, "value", item_neighbors),
                       np.int64), device=dev), persistent=False)
        self.conv_kernel = conv_kernel
        self.emb_user = _table(self.num_users, d, g, dev)
        self.emb_item = _table(self.num_items, d, g, dev)
        for name in ("u_conv", "i_conv"):
            conv = nn.Conv1d(d, conv_channels, conv_kernel, device=dev)
            _lecun_(conv.weight, d * conv_kernel, g)
            nn.init.zeros_(conv.bias)
            setattr(self, name, conv)
        self.mlp = MLP(d + 2 * conv_channels, mlp_hidden_units,
                       dropout=dropout, generator=g, device=dev)
        self.head = _dense(self.mlp.out_dim, 1, False, g, dev, xavier=True)

    def _neigh_repr(self, ids, table, conv):
        emb = _gather(table, ids)                              # (..., K, D)
        lead, k = emb.shape[:-2], emb.shape[-2]
        x = emb.reshape(-1, k, emb.shape[-1]).transpose(1, 2)  # (N, D, K)
        x = F.relu(conv(F.pad(x, _same_pad(k, self.conv_kernel, 1))))
        return torch.amax(x, dim=-1).reshape(*lead, -1)

    def score(self, batch, item_ids):
        u_ids = batch["user_id"].long()
        u = _gather(self.emb_user, u_ids)
        i = _gather(self.emb_item, item_ids)
        un = self._neigh_repr(self.user_neighbors[u_ids], self.emb_item,
                              self.u_conv)
        inr = self._neigh_repr(self.item_neighbors[item_ids.long()],
                               self.emb_user, self.i_conv)
        x = torch.cat([u[:, None] * i, un[:, None].expand(-1, i.shape[1], -1),
                       inr], dim=-1)
        return self.head(self.mlp(x))[..., 0]
