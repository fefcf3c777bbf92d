"""GNN and memory knowledge-aware recommenders: KGCN, KGNNLS, KGAT,
RippleNet.

Counterpart of `recbox_tpu/models/knowledge/gnn.py`, on the static
structures of `data.knowledge`:

  * KGCN / KGNNLS walk a fixed-K neighbour table: a (B·S, K^h) gather a
    hop, aggregated with the user-relation softmax attention;
  * KGAT propagates over the collaborative KG's edges with TransR edge
    attention (a softmax over each head's out-edges) and bi-interaction
    aggregation, the layer outputs concatenated;
  * RippleNet reads per-user ripple memories (B, H, M) from the batch.

The graph arrays (JAX's `StaticArray` fields) are non-persistent buffers
of the module, on its device, as the port's graph models hold their
edges; a model built without them raises AttributeError, as JAX's does on
its first call (`run_experiment` does not fill them, in either package).

KGAT's attention computes JAX's function per relation, not per edge: JAX
gathers W_r for every edge, an (E, D, k) operand twice a layer (7.7 GB in
f32 at 1.9M edges, D = 64, k = 16); the port forms P = emb @ W_r for every
relation, (R, N, k), and gathers P[r, h] + r_r and P[r, t] by
``index_select`` (whose backward adds with atomics; indexing a relation
table by 1.4M edge ids has an accumulating ``index_put_`` backward, which
took ~0.7 s a step on an H100). Each entry is the same D-term dot
product, summed by the matmul's blocking instead of the per-edge
einsum's; the two agree to f32 rounding
(`tests/test_torch_knowledge.py`). A Queue C divergence (`ROADMAP.md`).

Under a mesh the user, entity and node tables row-shard where JAX's
``_sharded()`` marks them (`parallel.mesh.shard_rows`); the relation
tables and ``rel_proj`` / ``rel_mat`` replicate. KGAT's propagation reads
every node at every layer, so it gathers ``emb_node`` whole once a
propagation (`parallel.mesh.whole_table`: (entities + users)·D·4 bytes
each way, the padding rows of a ragged last shard cut off before any
hop) and runs its layers on the whole table over the replicated edges; its
``kg_loss`` and the other three models read rows by id through the
mesh's exchange (`take`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import (
    MatchingModel, _l2_normalize, similarity_scores,
)
from recbox_tpu_torch.models.knowledge.models import take
from recbox_tpu_torch.models.matching.neural_cf import PairScoringModel
from recbox_tpu_torch.nn.attention import dense
from recbox_tpu_torch.nn.core import normal_table, xavier_param
from recbox_tpu_torch.parallel.mesh import whole_table

__all__ = ["KGCN", "KGNNLS", "KGAT", "RippleNet", "graph_buffer"]


def graph_buffer(module: nn.Module, name: str, value, device,
                 dtype: torch.dtype = torch.int64) -> None:
    """Hold the graph array ``value`` as the non-persistent buffer
    ``name``."""
    if value is None:
        raise AttributeError(
            f"{type(module).__name__} needs its graph array {name!r} "
            "(None given): build it from the KnowledgeGraph "
            "(data.knowledge) and pass it to the model")
    module.register_buffer(name, torch.as_tensor(
        np.asarray(value), dtype=dtype, device=device), persistent=False)


def segment_softmax(logits: torch.Tensor, segments: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of (E,) ``logits`` over the edges of each segment (the
    maximum taken without its gradient: the softmax does not depend on
    it)."""
    m = logits.new_full((num_segments,), float("-inf")).scatter_reduce(
        0, segments, logits.detach(), "amax")
    e = torch.exp(logits - m.index_select(0, segments))
    z = logits.new_zeros(num_segments).index_add_(0, segments, e)
    return e / torch.clamp(z.index_select(0, segments), min=1e-12)


class KGCN(PairScoringModel):
    """Knowledge graph convolutional network: the candidate item's h-hop
    receptive field aggregated with the user-specific relation attention
    π(u, r) = softmax_K(u · r); ``aggregator`` 'sum', 'neighbor' or
    'concat'."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 n_entities: int = 0, n_relations: int = 0, n_hops: int = 1,
                 aggregator: str = "sum", neighbor_entities=None,
                 neighbor_relations=None, num_users: int = 0,
                 num_items: int = 0, **kwargs):
        # the sizes by name, so build_model passes them from the config
        super().__init__(feature_map, embedding_dim, num_users=num_users,
                         num_items=num_items, **kwargs)
        g, dev, d = self._gen, self._dev, embedding_dim
        self.n_entities, self.n_relations = n_entities, n_relations
        self.n_hops, self.aggregator = int(n_hops), aggregator
        graph_buffer(self, "neighbor_entities", neighbor_entities, dev)
        graph_buffer(self, "neighbor_relations", neighbor_relations, dev)
        self.emb_user = normal_table((self.num_users, d), 0.01, g, dev,
                                     shard=True)
        self.emb_entity = normal_table((n_entities, d), 0.01, g, dev,
                                       shard=True)
        self.emb_rel = normal_table((n_relations, d), 0.01, g, dev)
        d_in = 2 * d if aggregator == "concat" else d
        for k in range(self.n_hops):
            setattr(self, f"agg{k}", dense(d_in, d, g, dev))

    def _receptive_field(self, items: torch.Tensor
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """items (B,) → per-hop entity and relation ids [(B, 1), (B, K),
        (B, K²), …] and [(B, K), (B, K²), …]."""
        b = items.shape[0]
        ents, rels = [items.reshape(b, 1).long()], []
        for _ in range(self.n_hops):
            prev = ents[-1].reshape(b, -1)
            ents.append(self.neighbor_entities[prev].reshape(b, -1))
            rels.append(self.neighbor_relations[prev].reshape(b, -1))
        return ents, rels

    def _aggregate(self, user_emb: torch.Tensor,
                   items: torch.Tensor) -> torch.Tensor:
        """One candidate column: items (B,) → (B, D) representations."""
        ents, rels = self._receptive_field(items)
        k = self.neighbor_entities.shape[1]
        vecs = [take(self.emb_entity, e) for e in ents]      # (B, K^h, D)
        for depth in range(self.n_hops, 0, -1):
            nxt = []
            for hop in range(depth):
                self_v = vecs[hop]
                neigh = vecs[hop + 1].reshape(self_v.shape[0],
                                              self_v.shape[1], k, -1)
                r = take(self.emb_rel, rels[hop]).reshape(neigh.shape)
                pi = torch.softmax(torch.einsum("bd,bnkd->bnk", user_emb, r),
                                   dim=-1)
                agg = torch.einsum("bnk,bnkd->bnd", pi, neigh)
                lin = getattr(self, f"agg{self.n_hops - depth}")
                if self.aggregator == "neighbor":
                    out = lin(agg)
                elif self.aggregator == "concat":
                    out = lin(torch.cat([self_v, agg], dim=-1))
                else:
                    out = lin(self_v + agg)
                nxt.append(torch.tanh(out) if depth == 1 else torch.relu(out))
            vecs = nxt
        return vecs[0][:, 0]

    def score(self, batch, item_ids):
        u = take(self.emb_user, batch["user_id"])
        b, s = item_ids.shape
        u_rep = torch.repeat_interleave(u, s, dim=0)
        i_rep = self._aggregate(u_rep, item_ids.reshape(-1))
        return torch.sum(u_rep * i_rep, dim=-1).reshape(b, s)


class KGNNLS(KGCN):
    """KGCN with label smoothness: the interaction labels propagate over
    the same receptive field with the user-relation weights, the
    candidate's own label held out at 0.5; ``ls_loss`` is the BCE of the
    propagated label against the truth."""

    def label_propagate(self, batch, item_ids: torch.Tensor,
                        item_labels: torch.Tensor) -> torch.Tensor:
        """item_labels (B, n_entities): 1 on the user's items. The
        predicted labels (B, S)."""
        u = take(self.emb_user, batch["user_id"])
        k = self.neighbor_entities.shape[1]
        b, s = item_ids.shape
        u_rep = torch.repeat_interleave(u, s, dim=0)
        lab = torch.repeat_interleave(item_labels, s, dim=0).clone()
        flat = item_ids.reshape(-1).long()
        lab[torch.arange(lab.shape[0], device=lab.device), flat] = 0.5
        ents, rels = self._receptive_field(flat)
        labs = [torch.gather(lab, 1, e) for e in ents]
        for depth in range(self.n_hops, 0, -1):
            nxt = []
            for hop in range(depth):
                self_l = labs[hop]
                neigh = labs[hop + 1].reshape(self_l.shape[0],
                                              self_l.shape[1], k)
                r = take(self.emb_rel, rels[hop]).reshape(
                    neigh.shape + (-1,))
                pi = torch.softmax(torch.einsum("bd,bnkd->bnk", u_rep, r),
                                   dim=-1)
                nxt.append(torch.einsum("bnk,bnk->bn", pi, neigh))
            labs = nxt
        return labs[0][:, 0].reshape(b, s)

    def ls_loss(self, batch, item_ids, item_labels,
                targets) -> torch.Tensor:
        pred = torch.clamp(self.label_propagate(batch, item_ids, item_labels),
                           1e-6, 1 - 1e-6)
        return -torch.mean(targets * torch.log(pred)
                           + (1 - targets) * torch.log(1 - pred))


class KGAT(MatchingModel):
    """Knowledge graph attention network: users and entities in one table
    (``emb_node``, users after the entities), attentive propagation over
    the collaborative KG with TransR attention and bi-interaction
    aggregation (``agg_sum<k>``, ``agg_bi<k>``), the normalised layer
    outputs concatenated."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 num_users: int = 0, n_entities: int = 0,
                 n_relations: int = 0, n_layers: int = 2, kg_dim: int = 16,
                 ckg_heads=None, ckg_relations=None, ckg_tails=None,
                 generator=None, device=None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        d = embedding_dim
        self.num_users, self.n_entities = num_users, n_entities
        self.n_relations, self.n_layers = n_relations, n_layers
        graph_buffer(self, "ckg_heads", ckg_heads, dev)
        graph_buffer(self, "ckg_relations", ckg_relations, dev)
        graph_buffer(self, "ckg_tails", ckg_tails, dev)
        self.emb_node = normal_table((n_entities + num_users, d), 0.01, g,
                                     dev, shard=True)
        self.emb_rel = normal_table((n_relations, kg_dim), 0.01, g, dev)
        self.rel_proj = xavier_param((n_relations, d, kg_dim), g, dev)
        for k in range(n_layers):
            setattr(self, f"agg_sum{k}", dense(d, d, g, dev))
            setattr(self, f"agg_bi{k}", dense(d, d, g, dev))

    def _attention(self, emb: torch.Tensor) -> torch.Tensor:
        """π(h, r, t) = (W_r e_t) · tanh(W_r e_h + r), softmaxed over each
        head's out-edges; W_r e for every relation first, then gathered
        per edge (see the module docstring)."""
        h, r, t = self.ckg_heads, self.ckg_relations, self.ckg_tails
        n, k = emb.shape[0], self.rel_proj.shape[2]
        proj = torch.einsum("nd,rdk->rnk", emb, self.rel_proj)  # (R, N, k)
        # W_r e_h + r for every (relation, node), then one row an edge
        head = (proj + self.emb_rel[:, None, :]).reshape(-1, k)
        eh = head.index_select(0, r * n + h)
        et = proj.reshape(-1, k).index_select(0, r * n + t)
        logits = torch.sum(et * torch.tanh(eh), dim=-1)
        return segment_softmax(logits, h, n)

    def propagated(self) -> torch.Tensor:
        h, t = self.ckg_heads, self.ckg_tails
        x = whole_table(self.emb_node)
        layers = [x]
        for k in range(self.n_layers):
            att = self._attention(x)
            agg = torch.zeros_like(x).index_add_(
                0, h, x.index_select(0, t) * att[:, None])
            x = (F.leaky_relu(getattr(self, f"agg_sum{k}")(x + agg), 0.2)
                 + F.leaky_relu(getattr(self, f"agg_bi{k}")(x * agg), 0.2))
            x = _l2_normalize(x)
            layers.append(x)
        return torch.cat(layers, dim=-1)

    def _users(self, emb, batch):
        ids = batch[self.feature_map.query_index].reshape(-1).long()
        return emb.index_select(0, ids + self.n_entities)

    def user_tower(self, batch):
        return self._users(self.propagated(), batch)

    def item_tower(self, batch):
        return self.propagated().index_select(
            0, batch[self.feature_map.corpus_index].reshape(-1).long())

    def forward(self, batch):
        emb = self.propagated()
        user_emb = self._users(emb, batch)
        item_ids = batch["__item_ids__"]
        item_emb = emb.index_select(0, item_ids.reshape(-1).long())
        return similarity_scores(user_emb, item_emb, item_ids.shape[1],
                                 self.similarity, self.temperature)

    def kg_loss(self, batch) -> torch.Tensor:
        """TransR BPR on collaborative-KG triples."""
        m = take(self.rel_proj, batch["kg_relation"])
        re = take(self.emb_rel, batch["kg_relation"])
        emb = self.emb_node
        hp = torch.einsum("bd,bdk->bk", take(emb, batch["kg_head"]), m)
        tp = torch.einsum("bd,bdk->bk", take(emb, batch["kg_tail"]), m)
        tn = torch.einsum("bd,bdk->bk", take(emb, batch["kg_neg_tail"]), m)
        pos = -torch.sum(torch.square(hp + re - tp), dim=-1)
        neg = -torch.sum(torch.square(hp + re - tn), dim=-1)
        return -torch.mean(F.logsigmoid(pos - neg))


class RippleNet(PairScoringModel):
    """RippleNet: the user's ripple memories attend against the candidate;
    o_h = Σ_m softmax(v · R_m h_m) t_m and score = v · Σ_h o_h. The batch
    carries ``ripple_heads`` / ``ripple_relations`` / ``ripple_tails``
    (B, H, M) from `data.knowledge.build_ripple_sets`."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 n_entities: int = 0, n_relations: int = 0, n_hops: int = 2,
                 num_users: int = 0, num_items: int = 0, **kwargs):
        # the sizes by name, so build_model passes them from the config
        super().__init__(feature_map, embedding_dim, num_users=num_users,
                         num_items=num_items, **kwargs)
        g, dev, d = self._gen, self._dev, embedding_dim
        self.n_entities, self.n_relations = n_entities, n_relations
        self.n_hops = int(n_hops)
        self.emb_entity = normal_table((n_entities, d), 0.01, g, dev,
                                       shard=True)
        self.rel_mat = xavier_param((n_relations, d, d), g, dev)

    def score(self, batch, item_ids):
        v = take(self.emb_entity, item_ids)                      # (B, S, D)
        h_e = take(self.emb_entity, batch["ripple_heads"])       # (B, H, M, D)
        t_e = take(self.emb_entity, batch["ripple_tails"])
        r = take(self.rel_mat, batch["ripple_relations"])        # (B,H,M,D,D)
        rh = torch.einsum("bhmde,bhme->bhmd", r, h_e)
        o = torch.zeros_like(v)
        for hop in range(self.n_hops):
            p = torch.softmax(torch.einsum("bsd,bmd->bsm", v, rh[:, hop]),
                              dim=-1)
            o = o + torch.einsum("bsm,bmd->bsd", p, t_e[:, hop])
        return torch.sum(v * o, dim=-1)

    def kg_loss(self, batch) -> torch.Tensor:
        """σ(hᵀ R t) up for the true ripple triples."""
        h_e = take(self.emb_entity, batch["ripple_heads"])
        t_e = take(self.emb_entity, batch["ripple_tails"])
        r = take(self.rel_mat, batch["ripple_relations"])
        s = torch.einsum("bhmd,bhmde,bhme->bhm", h_e, r, t_e)
        return -torch.mean(F.logsigmoid(s))
