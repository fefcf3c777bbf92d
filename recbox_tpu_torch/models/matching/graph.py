"""Graph collaborative filtering: LightGCN and NGCF.

Counterpart of `recbox_tpu/models/matching/graph.py`. The bipartite
user-item graph is an edge list with symmetric coefficients
1/√(deg(u)·deg(i)) (`build_norm_edges`, a numpy copy); each propagation hop
gathers one side's rows per edge, scales them by the edge's coefficient
and adds them into the other side with ``index_add_``, JAX's
``segment_sum``. The edge arrays are buffers of the module, on its device,
so a captured training step reads them in place (they are not part of
the ``state_dict``: the graph is the model's definition, like its
widths). On the card
``index_add_`` adds with atomics, in no fixed order, so two runs of a hop
may differ in the last bits; on the CPU it adds in edge order, not in
``segment_sum``'s.

LightGCN averages the K hops' outputs (no transforms); NGCF applies per-hop
dense transforms with a bi-interaction term and concatenates the
L2-normalized hop outputs. Both propagate once a training step
(`forward`): each tower alone (`encode_user` / `encode_item`, evaluation
and serving) propagates again, as in JAX. The tables are the parameters
``emb_user`` and ``emb_item``, and NGCF's hop k is the module ``gnn<k>``
with Linear ``w1`` and ``w2``: flax's names, so `interop.from_jax_params`
maps a JAX param tree onto them.

Under a mesh the two tables row-shard (`parallel.mesh.shard_rows`, JAX's
``nn.with_partitioning`` of ``_GraphBase._table_init``). A hop reads
every row, so a propagation gathers each table whole once at its top
(`parallel.mesh.whole_table`: (U + I)·D·4 bytes, and as many again for
the gradient's 'data' sum in the backward) and runs the hops on the
whole tables over the replicated edge buffers: no term in the edge count.
Sharding divides the tables and their Adam moments by the world; the
step's peak stays whole (the gathered tables and the hops' activations).
Each call of ``propagated`` is a collective: every rank calls it as often
(the trainer's steps, each encode batch of the evaluators and the
service).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import (
    MatchingModel, _l2_normalize, similarity_scores,
)
from recbox_tpu_torch.nn.core import (
    _TRUNC_STD, Dropout, normal_table, xavier_normal_, xavier_uniform_,
)
from recbox_tpu_torch.parallel.mesh import shard_rows, whole_table

__all__ = ["LightGCN", "NGCF", "build_norm_edges"]

Device = Optional[Union[str, torch.device]]


def build_norm_edges(user_ids: np.ndarray, item_ids: np.ndarray,
                     num_users: int, num_items: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(edge users int32, edge items int32, coefficients 1/√(dᵤ·dᵢ) f32)
    from interactions; repeated (u, i) pairs count once (a binary
    adjacency)."""
    pairs = np.unique(np.stack([user_ids, item_ids], axis=1), axis=0)
    u, i = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    du = np.bincount(u, minlength=num_users).astype(np.float64)
    di = np.bincount(i, minlength=num_items).astype(np.float64)
    coef = 1.0 / np.sqrt(np.maximum(du[u], 1) * np.maximum(di[i], 1))
    return u, i, coef.astype(np.float32)


def _lecun_normal_(t: torch.Tensor, generator: Optional[torch.Generator]
                   ) -> torch.Tensor:
    """flax's Dense default kernel init: truncated normal at fan_in
    variance (fan_in = the torch weight's columns)."""
    std = math.sqrt(1.0 / t.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def _table(rows: int, dim: int, scheme: str, generator, device
           ) -> nn.Parameter:
    """A table of ``scheme``'s draw, marked for row-sharding under a mesh
    (JAX's ``_table_init``)."""
    if scheme == "normal":
        return normal_table((rows, dim), 1e-4, generator, device,
                            shard=True)
    w = torch.empty(rows, dim, device=device)
    if scheme == "xavier_uniform":
        xavier_uniform_(w, generator)
    elif scheme == "xavier_normal":
        xavier_normal_(w, generator)
    else:   # a typo would silently confound init experiments: refuse
        raise ValueError(f"emb_init_scheme={scheme!r}: expected 'normal' | "
                         "'xavier_uniform' | 'xavier_normal'")
    return shard_rows(nn.Parameter(w))


class _GraphBase(MatchingModel):
    """The edge buffers, the tables and one propagation hop."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 num_users: int = 0, num_items: int = 0, n_layers: int = 2,
                 edge_users: Sequence[int] = (),
                 edge_items: Sequence[int] = (),
                 edge_coefs: Sequence[float] = (),
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        self.num_users, self.num_items = int(num_users), int(num_items)
        self.n_layers = int(n_layers)
        self.emb_init_scheme = emb_init_scheme
        self.register_buffer("edge_users", torch.as_tensor(
            np.asarray(edge_users, np.int64), device=dev),
            persistent=False)
        self.register_buffer("edge_items", torch.as_tensor(
            np.asarray(edge_items, np.int64), device=dev),
            persistent=False)
        self.register_buffer("edge_coefs", torch.as_tensor(
            np.asarray(edge_coefs, np.float32), device=dev),
            persistent=False)
        self.emb_user = _table(self.num_users, embedding_dim,
                               emb_init_scheme, g, dev)
        self.emb_item = _table(self.num_items, embedding_dim,
                               emb_init_scheme, g, dev)
        self._generator = g

    def _propagate_hop(self, user_emb: torch.Tensor, item_emb: torch.Tensor,
                       coefs: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One symmetric-normalized hop; ``coefs`` replaces the edge
        coefficients."""
        u, i = self.edge_users, self.edge_items
        c = (self.edge_coefs if coefs is None else coefs)[:, None]
        to_user = user_emb.new_zeros(self.num_users, item_emb.shape[1]) \
            .index_add_(0, u, item_emb.index_select(0, i) * c)
        to_item = item_emb.new_zeros(self.num_items, user_emb.shape[1]) \
            .index_add_(0, i, user_emb.index_select(0, u) * c)
        return to_user, to_item

    def _tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The user and item tables, whole: under a mesh gathered from
        every rank's rows (a collective)."""
        return whole_table(self.emb_user), whole_table(self.emb_item)

    def propagated(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def user_tower(self, batch):
        ue, _ = self.propagated()
        return ue.index_select(0, batch[self.feature_map.query_index]
                               .reshape(-1))

    def item_tower(self, batch):
        _, ie = self.propagated()
        return ie.index_select(0, batch[self.feature_map.corpus_index]
                               .reshape(-1))

    def forward(self, batch):
        """(B, 1 + num_negs) scores of a training batch, the graph
        propagated once for both sides."""
        ue, ie = self.propagated()
        user_emb = ue.index_select(0, batch[self.feature_map.query_index]
                                   .reshape(-1))
        item_ids = batch["__item_ids__"]
        item_emb = ie.index_select(0, item_ids.reshape(-1))
        return similarity_scores(user_emb, item_emb, item_ids.shape[1],
                                 self.similarity, self.temperature)


class LightGCN(_GraphBase):
    """LightGCN: K parameter-free hops, the mean over the layer outputs
    (the input tables included)."""

    def propagated(self, coefs: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        ue, ie = self._tables()
        user_layers, item_layers = [ue], [ie]
        for _ in range(self.n_layers):
            ue, ie = self._propagate_hop(ue, ie, coefs)
            user_layers.append(ue)
            item_layers.append(ie)
        return (torch.mean(torch.stack(user_layers), dim=0),
                torch.mean(torch.stack(item_layers), dim=0))


class _NGCFLayer(nn.Module):
    """leaky_relu(W1 (side + ego) + W2 (side ⊙ ego)), slope 0.2; flax
    Dense's init (lecun normal kernels, zero biases)."""

    def __init__(self, dim: int, generator, device):
        super().__init__()
        self.w1 = nn.Linear(dim, dim, device=device)
        self.w2 = nn.Linear(dim, dim, device=device)
        for lin in (self.w1, self.w2):
            _lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, ego: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.w1(side + ego) + self.w2(side * ego),
                            negative_slope=0.2)


class NGCF(_GraphBase):
    """NGCF: transformed propagation with bi-interaction, the concatenation
    of the input tables and each hop's L2-normalized output. ``dropout``
    drops each hop's output in training (message dropout), from the
    trainer's generator."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 dropout: float = 0.0, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        dev = self.emb_user.device
        self.dropout = float(dropout)
        for k in range(self.n_layers):
            setattr(self, f"gnn{k}",
                    _NGCFLayer(embedding_dim, self._generator, dev))
        self.msg_dropout = Dropout(self.dropout)

    def propagated(self) -> Tuple[torch.Tensor, torch.Tensor]:
        ue, ie = self._tables()
        user_layers, item_layers = [ue], [ie]
        for k in range(self.n_layers):
            layer = getattr(self, f"gnn{k}")
            su, si = self._propagate_hop(ue, ie)
            ue = layer(ue, su)
            ie = layer(ie, si)
            if self.dropout:
                ue = self.msg_dropout(ue)
                ie = self.msg_dropout(ie)
            user_layers.append(_l2_normalize(ue))
            item_layers.append(_l2_normalize(ie))
        return torch.cat(user_layers, dim=-1), torch.cat(item_layers, dim=-1)
