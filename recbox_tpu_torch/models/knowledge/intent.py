"""Intent-aware and contrastive KG recommenders: KGIN, MCCLK, and the
KG-memory sequential model KSR.

Counterpart of `recbox_tpu/models/knowledge/intent.py`, on the edge
buffers of `gnn.graph_buffer` (interaction edges ``inter_users`` /
``inter_items``, KG triples ``kg_heads`` / ``kg_relations`` /
``kg_tails``; KSR's ``kg_neighbors`` table) and ``index_add_``
aggregation. Parameter names are flax's (``emb_user``, ``emb_entity``,
``emb_rel``, ``intent_logits``; KSR's ``emb_item``, ``ksr_gru`` with its
``GRUCell_0``, ``q`` and ``out``).

Under a mesh ``emb_user``, ``emb_entity`` and KSR's ``emb_item`` row-shard
where JAX marks them (`parallel.mesh.shard_rows`); ``emb_rel`` and
``intent_logits`` replicate. KGIN and MCCLK propagate over every row, so a
forward gathers each table whole once (`_EdgeModel._tables`,
`parallel.mesh.whole_table`) and runs its hops on the whole tables over
the replicated edges; KSR reads its history and its KG memory by id
through the mesh's exchange (`parallel.mesh.lookup`).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import (
    MatchingModel, _l2_normalize, similarity_scores,
)
from recbox_tpu_torch.models.knowledge.gnn import graph_buffer
from recbox_tpu_torch.models.knowledge.models import take
from recbox_tpu_torch.models.matching.graph_extended import infonce
from recbox_tpu_torch.models.sequential.models import (
    SequentialRecommender, _last_valid, right_align_to_left,
)
from recbox_tpu_torch.nn.attention import dense
from recbox_tpu_torch.nn.core import Dropout, normal_table
from recbox_tpu_torch.nn.recurrent import GRUCell, rnn
from recbox_tpu_torch.parallel.mesh import (
    inbatch_columns, lookup, module_mesh, whole_table,
)

__all__ = ["KGIN", "MCCLK", "KSR"]

_EDGES = ("inter_users", "inter_items", "kg_heads", "kg_relations",
          "kg_tails")


def _degree(index: torch.Tensor, n: int) -> torch.Tensor:
    """Edges a node, at least 1 (f32)."""
    ones = torch.ones(index.shape[0], device=index.device)
    return torch.clamp(ones.new_zeros(n).index_add_(0, index, ones), min=1.0)


def _segment_sum(values: torch.Tensor, index: torch.Tensor,
                 n: int) -> torch.Tensor:
    return values.new_zeros((n,) + tuple(values.shape[1:])).index_add_(
        0, index, values)


class _EdgeModel(MatchingModel):
    """The tables and edge buffers KGIN and MCCLK share; subclasses give
    ``_towers()`` → (user table, item table)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 num_users: int = 0, n_entities: int = 0,
                 n_relations: int = 0, n_layers: int = 2,
                 inter_users=None, inter_items=None, kg_heads=None,
                 kg_relations=None, kg_tails=None, generator=None,
                 device=None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        self._gen = g
        d = embedding_dim
        self.num_users, self.n_entities = num_users, n_entities
        self.n_relations, self.n_layers = n_relations, n_layers
        for name, value in zip(_EDGES, (inter_users, inter_items, kg_heads,
                                        kg_relations, kg_tails)):
            graph_buffer(self, name, value, dev)
        self.emb_user = normal_table((num_users, d), 0.01, g, dev,
                                     shard=True)
        self.emb_entity = normal_table((n_entities, d), 0.01, g, dev,
                                       shard=True)
        self.emb_rel = normal_table((n_relations, d), 0.01, g, dev)

    def _tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The user and entity tables, whole: under a mesh gathered from
        every rank's rows (a collective)."""
        return whole_table(self.emb_user), whole_table(self.emb_entity)

    def _towers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _kg_aggregate(self, ent: torch.Tensor) -> torch.Tensor:
        """mean over each head's triples of r ⊙ e_t."""
        msg = take(self.emb_rel, self.kg_relations) \
            * ent.index_select(0, self.kg_tails)
        return _segment_sum(msg, self.kg_heads, self.n_entities) \
            / _degree(self.kg_heads, self.n_entities)[:, None]

    def user_tower(self, batch):
        return take(self._towers()[0], batch[self.feature_map.query_index])

    def item_tower(self, batch):
        return take(self._towers()[1], batch[self.feature_map.corpus_index])

    def forward(self, batch):
        ue, ie = self._towers()
        user_emb = take(ue, batch[self.feature_map.query_index])
        item_ids = batch["__item_ids__"]
        item_emb = take(ie, item_ids.reshape(-1))
        return similarity_scores(user_emb, item_emb, item_ids.shape[1],
                                 self.similarity, self.temperature)


class KGIN(_EdgeModel):
    """KG-based intent network: P user intents, each a softmax mixture of
    the relations; relational KG aggregation on the item side,
    intent-weighted interaction aggregation on the user side.
    ``independence_loss`` keeps the intents apart (cosine form)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 n_intents: int = 4, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        self.n_intents = n_intents
        self.intent_logits = normal_table((n_intents, self.n_relations), 0.1,
                                          self._gen,
                                          self.emb_user.device)

    def _intents(self) -> torch.Tensor:
        """(P, D) intents, softmax-over-relations mixtures."""
        return torch.softmax(self.intent_logits, dim=-1) @ self.emb_rel

    def propagated(self) -> Tuple[torch.Tensor, torch.Tensor]:
        iu, ii = self.inter_users, self.inter_items
        intents = self._intents()
        deg_u = _degree(iu, self.num_users)
        user_out, ent_out = self._tables()
        for _ in range(self.n_layers):
            ent_agg = self._kg_aggregate(ent_out)
            att = torch.softmax(user_out @ intents.T, dim=-1)       # (U, P)
            mix = att @ intents                                      # (U, D)
            msg_u = mix.index_select(0, iu) * ent_out.index_select(0, ii)
            user_agg = _segment_sum(msg_u, iu, self.num_users) \
                / deg_u[:, None]
            user_out = user_out + user_agg
            ent_out = ent_out + ent_agg
        return user_out, ent_out

    _towers = propagated

    def independence_loss(self) -> torch.Tensor:
        """Mean pairwise |cos| between the intents."""
        t = _l2_normalize(self._intents())
        gram = torch.abs(t @ t.T)
        p = gram.shape[0]
        return (torch.sum(gram) - p) / max(p * (p - 1), 1)


class MCCLK(_EdgeModel):
    """Multi-level cross-view contrastive KG recommendation (compact): a
    collaborative view (LightGCN over the interactions), a semantic view
    (relation-aware KG aggregation of the items), scores on the fused item
    embedding, and ``contrastive_loss`` aligning the two item views."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 ssl_tau: float = 0.2, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        self.ssl_tau = float(ssl_tau)

    def collaborative_view(self, tables=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tables``: the whole (user, entity) tables (`_tables`),
        gathered here when not given."""
        iu, ii = self.inter_users, self.inter_items
        du = _degree(iu, self.num_users)
        di = _degree(ii, self.n_entities)
        coef = (1.0 / torch.sqrt(du.index_select(0, iu)
                                 * di.index_select(0, ii)))[:, None]
        ue, ie = self._tables() if tables is None else tables
        u_layers, i_layers = [ue], [ie]
        for _ in range(self.n_layers):
            msg_u = _segment_sum(i_layers[-1].index_select(0, ii) * coef,
                                 iu, self.num_users)
            msg_i = _segment_sum(u_layers[-1].index_select(0, iu) * coef,
                                 ii, self.n_entities)
            u_layers.append(msg_u)
            i_layers.append(msg_i)
        return (torch.mean(torch.stack(u_layers), 0),
                torch.mean(torch.stack(i_layers), 0))

    def semantic_view(self, entities=None) -> torch.Tensor:
        """``entities``: the whole entity table, gathered here when not
        given."""
        out = whole_table(self.emb_entity) if entities is None \
            else entities
        for _ in range(self.n_layers):
            out = out + self._kg_aggregate(out)
        return out

    def contrastive_loss(self, batch) -> torch.Tensor:
        """InfoNCE between the batch's positives' collaborative and
        semantic views, in-batch negatives. Under a mesh
        (`parallel.mesh.module_mesh`) the negatives are the global batch's
        positives, as under JAX's sharded trainer: their ids gathered over
        'data', their semantic rows read from this rank's whole views (the
        tables' gradient is summed over 'data' by `whole_table`)."""
        tables = self._tables()
        _, collab_i = self.collaborative_view(tables)
        sem = self.semantic_view(tables[1])
        pos = batch["__item_ids__"][:, 0].long()
        mesh = module_mesh(self)
        if mesh is None:
            return infonce(collab_i[pos], sem[pos], self.ssl_tau)
        cols, offset = inbatch_columns(pos, mesh)
        return infonce(collab_i[pos], sem[cols], self.ssl_tau, offset)

    def _towers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        tables = self._tables()
        ue, collab_i = self.collaborative_view(tables)
        return ue, collab_i + self.semantic_view(tables[1])


class _KSREncoder(nn.Module):
    """Dropout, a GRU over the history, its last valid state."""

    def __init__(self, dim: int, hidden: int, dropout: float, generator,
                 device):
        super().__init__()
        self.drop = Dropout(dropout)
        self.GRUCell_0 = GRUCell(dim, hidden, generator, device)

    def forward(self, emb, seq_len):
        return _last_valid(rnn(self.GRUCell_0, self.drop(emb)), seq_len)


class KSR(SequentialRecommender):
    """Knowledge-enhanced sequential recommendation: a GRU interest state
    and a key-value KG memory (the KG neighbours of the consumed items,
    attended by the projected state); user = Dense([q ‖ memory])."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = True,
                 num_users: int = 0, n_entities: int = 0,
                 hidden_size: int = 64, kg_neighbors=None,
                 generator=None, device=None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        g, dev, d = self._gen, self._dev, embedding_dim
        self.num_users, self.n_entities = num_users, n_entities
        graph_buffer(self, "kg_neighbors", kg_neighbors, dev)
        self.emb_entity = normal_table((n_entities, d), 0.01, g, dev,
                                       shard=True)
        self.ksr_gru = _KSREncoder(d, hidden_size, dropout, g, dev)
        self.q = dense(hidden_size, d, g, dev, bias=False)
        self.out = dense(2 * d, d, g, dev)

    def user_tower(self, batch):
        seq = right_align_to_left(batch["item_seq"].long(), batch["seq_len"])
        mask = seq != 0
        emb = lookup(self._table(), seq, self._shard(), embedding=True) \
            * mask[..., None].to(torch.float32)
        h = self.ksr_gru(emb, batch["seq_len"])
        neigh = self.kg_neighbors[torch.clamp(seq, 0, self.n_entities - 1)]
        b, length, k = neigh.shape
        mem = lookup(self.emb_entity, neigh.reshape(b, length * k),
                     embedding=True)
        mem_mask = torch.repeat_interleave(mask, k, dim=1)
        q = self.q(h)
        att = torch.einsum("bmd,bd->bm", mem, q)
        att = torch.softmax(torch.where(mem_mask, att,
                                        torch.full_like(att, -1e9)), dim=-1)
        m = torch.einsum("bm,bmd->bd", att, mem)
        return self.out(torch.cat([q, m], dim=-1))
