"""Translation-based knowledge-aware recommenders: CKE, CFKG, KTUP, MKR.

Counterpart of `recbox_tpu/models/knowledge/models.py`. KG supervision is a
``kg_loss(batch)`` method over a batch of triples (``kg_head``,
``kg_relation``, ``kg_tail``, ``kg_neg_tail``), which `run_kg_experiment`
trains in its KG phase; the CF path stays a dot product where the model
factors (CFKG folds its translation distance into an augmented table).

The tables carry flax's names and draws: ``emb_user`` / ``emb_item``
normal(1e-4) in CKE, normal(0.01) elsewhere, ``emb_entity``, ``emb_rel``
normal(0.01), ``rel_proj`` xavier-normal in flax's (R, D, k) layout, MKR's
cross & compress units ``cc<k>`` (``w_vv``, ``w_ev``, ``w_ve``, ``w_ee``
(D, 1), ``b_v``, ``b_e``) and MLPs ``user_mlp`` / ``kg_mlp``.

MKR's KG head (``kg_mlp``) is made with the model: flax makes it only on
the first ``kg_loss`` call, and JAX's `run_kg_experiment` then initialises
it apart and merges it into the trained tree (`recbox_tpu/quick_start.py
:553-562`). A Queue C divergence (`ROADMAP.md`): the head's initial draw
comes from the model's generator, not from a key of seed + 1.

Under a mesh the user, item and entity tables row-shard where JAX's
``_sharded()`` marks them (`parallel.mesh.shard_rows`); the relation
tables and projections replicate. Every read of a marked table is by id
(`take`, the mesh's exchange): CKE's item side is two lookups (the item
and the entity tables shard over different row counts), and CFKG's
augmented table, a per-row function of the entity table, is computed on
this rank's rows and read with the entity table's `RowShard`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import MatchingModel, _l2_normalize
from recbox_tpu_torch.models.matching.neural_cf import PairScoringModel
from recbox_tpu_torch.nn.core import MLP, normal_table, xavier_param
from recbox_tpu_torch.parallel.mesh import lookup, row_shard

__all__ = ["CKE", "CFKG", "KTUP", "MKR"]

Device = Optional[Union[str, torch.device]]


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (any shape), ``jnp.take`` on axis 0, by
    `F.embedding` (a (R, D, k) table as R rows of D·k): its backward sums
    a repeated id's rows in parallel segments, where indexing's
    accumulating ``index_put_`` adds them one after another (a relation
    id repeats over every edge of the collaborative KG). A 2-D table goes
    through `parallel.mesh.lookup`: a table marked for row-sharding reads
    its rows through the mesh's exchange under a mesh (a collective)."""
    if table.ndim == 2:
        return lookup(table, ids, embedding=True)
    rows = F.embedding(ids, table.reshape(table.shape[0], -1))
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def _l2sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x), dim=-1)


def _bpr(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    return -torch.mean(F.logsigmoid(pos - neg))


class CKE(MatchingModel):
    """Collaborative knowledge embedding: MF scoring with item = item
    embedding + entity embedding; TransR on the KG triples."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 num_users: int = 0, num_items: int = 0,
                 n_entities: int = 0, n_relations: int = 0,
                 kg_dim: int = 32,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        d = embedding_dim
        self.num_users, self.num_items = num_users, num_items
        self.n_entities, self.n_relations = n_entities, n_relations
        self.emb_user = normal_table((num_users, d), 1e-4, g, dev,
                                     shard=True)
        self.emb_item = normal_table((num_items, d), 1e-4, g, dev,
                                     shard=True)
        self.emb_entity = normal_table((n_entities, d), 0.01, g, dev,
                                       shard=True)
        self.emb_rel = normal_table((n_relations, kg_dim), 0.01, g, dev)
        self.rel_proj = xavier_param((n_relations, d, kg_dim), g, dev)

    def user_tower(self, batch):
        return take(self.emb_user, batch[self.feature_map.query_index])

    def item_tower(self, batch):
        ids = batch[self.feature_map.corpus_index]
        return take(self.emb_item, ids) + take(self.emb_entity, ids)

    def kg_loss(self, batch) -> torch.Tensor:
        """TransR BPR of (h, r, t) against (h, r, t')."""
        h = take(self.emb_entity, batch["kg_head"])
        t = take(self.emb_entity, batch["kg_tail"])
        tn = take(self.emb_entity, batch["kg_neg_tail"])
        r = take(self.emb_rel, batch["kg_relation"])
        m = take(self.rel_proj, batch["kg_relation"])
        hp = torch.einsum("bd,bdk->bk", h, m)
        tp = torch.einsum("bd,bdk->bk", t, m)
        tnp_ = torch.einsum("bd,bdk->bk", tn, m)
        return _bpr(-_l2sq(hp + r - tp), -_l2sq(hp + r - tnp_))


class CFKG(MatchingModel):
    """CF as a knowledge graph: users, items and entities in one
    translation space; score(u, i) = −‖e_u + r_interact − e_i‖², expanded
    into a dot product of [e_u + r, 1] and [2 e_i, −‖e_i‖²]."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 num_users: int = 0, n_entities: int = 0,
                 n_relations: int = 1,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        d = embedding_dim
        self.num_users, self.n_entities = num_users, n_entities
        self.n_relations = n_relations
        self.emb_user = normal_table((num_users, d), 0.01, g, dev,
                                     shard=True)
        self.emb_entity = normal_table((n_entities, d), 0.01, g, dev,
                                       shard=True)
        self.emb_rel = normal_table((n_relations, d), 0.01, g, dev)

    def full_scores_table(self) -> torch.Tensor:
        """[2 e, −‖e‖²] of each entity row; under a mesh of this rank's
        rows."""
        e = self.emb_entity
        return torch.cat([2.0 * e, -_l2sq(e)[:, None]], dim=1)

    def user_tower(self, batch):
        x = take(self.emb_user, batch[self.feature_map.query_index]) \
            + self.emb_rel[0][None, :]
        return torch.cat([x, x.new_ones(x.shape[0], 1)], dim=-1)

    def item_tower(self, batch):
        return lookup(self.full_scores_table(),
                      batch[self.feature_map.corpus_index],
                      row_shard(self.emb_entity), embedding=True)

    def kg_loss(self, batch) -> torch.Tensor:
        """TransE BPR on the KG triples."""
        h = take(self.emb_entity, batch["kg_head"])
        t = take(self.emb_entity, batch["kg_tail"])
        tn = take(self.emb_entity, batch["kg_neg_tail"])
        r = take(self.emb_rel, batch["kg_relation"])
        return _bpr(-_l2sq(h + r - t), -_l2sq(h + r - tn))


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x off the hyperplane of normal w (TransH)."""
    w = _l2_normalize(w)
    return x - torch.sum(x * w, dim=-1, keepdim=True) * w


class KTUP(PairScoringModel):
    """KTUP: TransH scoring with soft preference induction, the (u, i)
    pair attending over P preference relations."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 n_entities: int = 0, n_relations: int = 0,
                 n_preferences: int = 4, num_users: int = 0,
                 num_items: int = 0, **kwargs):
        # the sizes by name, so build_model passes them from the config
        super().__init__(feature_map, embedding_dim, num_users=num_users,
                         num_items=num_items, **kwargs)
        g, dev, d = self._gen, self._dev, embedding_dim
        self.n_entities, self.n_relations = n_entities, n_relations
        self.emb_user = normal_table((self.num_users, d), 0.01, g, dev,
                                     shard=True)
        self.emb_entity = normal_table((n_entities, d), 0.01, g, dev,
                                       shard=True)
        self.emb_pref = normal_table((n_preferences, d), 0.01, g, dev)
        self.emb_pref_norm = normal_table((n_preferences, d), 0.01, g, dev)
        self.emb_rel = normal_table((n_relations, d), 0.01, g, dev)
        self.emb_rel_norm = normal_table((n_relations, d), 0.01, g, dev)

    def score(self, batch, item_ids):
        u = take(self.emb_user, batch["user_id"])
        i = take(self.emb_entity, item_ids)                       # (B, S, D)
        alpha = torch.softmax(torch.einsum(
            "bsd,pd->bsp", u[:, None] + i, self.emb_pref), dim=-1)
        r = torch.einsum("bsp,pd->bsd", alpha, self.emb_pref)
        w = torch.einsum("bsp,pd->bsd", alpha, self.emb_pref_norm)
        u_p = _project(u[:, None].expand_as(i), w)
        return -_l2sq(u_p + r - _project(i, w))

    def kg_loss(self, batch) -> torch.Tensor:
        """TransH BPR on the KG triples."""
        h = take(self.emb_entity, batch["kg_head"])
        t = take(self.emb_entity, batch["kg_tail"])
        tn = take(self.emb_entity, batch["kg_neg_tail"])
        r = take(self.emb_rel, batch["kg_relation"])
        w = take(self.emb_rel_norm, batch["kg_relation"])
        hp = _project(h, w)
        return _bpr(-_l2sq(hp + r - _project(t, w)),
                    -_l2sq(hp + r - _project(tn, w)))


class _CrossCompress(nn.Module):
    """MKR's cross & compress unit: C = v eᵀ, v' = C w_vv + Cᵀ w_ev + b_v
    (and e' alike), without forming C: C w = v (e · w)."""

    def __init__(self, dim: int, generator, device):
        super().__init__()
        for name in ("w_vv", "w_ev", "w_ve", "w_ee"):
            setattr(self, name, xavier_param((dim, 1), generator, device))
        self.b_v = nn.Parameter(torch.zeros(dim, device=device))
        self.b_e = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, v: torch.Tensor, e: torch.Tensor):
        ev = torch.sum(e * self.w_vv[:, 0], dim=-1, keepdim=True)
        ve = torch.sum(v * self.w_ev[:, 0], dim=-1, keepdim=True)
        ee = torch.sum(e * self.w_ve[:, 0], dim=-1, keepdim=True)
        vv = torch.sum(v * self.w_ee[:, 0], dim=-1, keepdim=True)
        return v * ev + e * ve + self.b_v, v * ee + e * vv + self.b_e


class MKR(MatchingModel):
    """Multi-task KG + recommendation: the item path runs ``n_layers_cc``
    cross & compress units against the item's entity, the user path an
    MLP; the KG task predicts tails from MLP([h ‖ r]) through the same
    units."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 num_users: int = 0, num_items: int = 0,
                 n_entities: int = 0, n_relations: int = 0,
                 n_layers_cc: int = 1, user_hidden: Sequence[int] = (64,),
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        d = embedding_dim
        self.num_users, self.num_items = num_users, num_items
        self.n_entities, self.n_relations = n_entities, n_relations
        self.n_layers_cc = n_layers_cc
        self.emb_user = normal_table((num_users, d), 0.01, g, dev,
                                     shard=True)
        self.emb_item = normal_table((num_items, d), 0.01, g, dev,
                                     shard=True)
        self.emb_entity = normal_table((n_entities, d), 0.01, g, dev,
                                       shard=True)
        self.emb_rel = normal_table((n_relations, d), 0.01, g, dev)
        for k in range(n_layers_cc):
            setattr(self, f"cc{k}", _CrossCompress(d, g, dev))
        self.user_mlp = MLP(d, tuple(user_hidden), output_dim=d, generator=g,
                            device=dev)
        self.kg_mlp = MLP(2 * d, (d,), output_dim=d, generator=g, device=dev)

    def _item_repr(self, item_ids):
        v = take(self.emb_item, item_ids)
        e = take(self.emb_entity, item_ids)
        for k in range(self.n_layers_cc):
            v, e = getattr(self, f"cc{k}")(v, e)
        return v, e

    def user_tower(self, batch):
        return self.user_mlp(take(self.emb_user,
                                  batch[self.feature_map.query_index]))

    def item_tower(self, batch):
        return self._item_repr(batch[self.feature_map.corpus_index])[0]

    def kg_loss(self, batch) -> torch.Tensor:
        """Tail prediction through the shared units: σ(t̂ · t) up for true
        tails, down for corrupted ones."""
        h_ids = batch["kg_head"]
        _, e = self._item_repr(torch.clamp(h_ids, 0, self.num_items - 1))
        h_emb = torch.where((h_ids < self.num_items)[:, None], e,
                            take(self.emb_entity, h_ids))
        r = take(self.emb_rel, batch["kg_relation"])
        t_hat = self.kg_mlp(torch.cat([h_emb, r], dim=-1))
        pos = torch.sum(t_hat * take(self.emb_entity, batch["kg_tail"]), -1)
        neg = torch.sum(t_hat * take(self.emb_entity, batch["kg_neg_tail"]),
                        -1)
        return -torch.mean(F.logsigmoid(pos) + F.logsigmoid(-neg))
