"""Extended graph collaborative filtering: SGL, NCL, DGCF, SpectralCF,
GCMC, LINE.

Counterpart of `recbox_tpu/models/matching/graph_extended.py`, on the
port's edge buffers and hops (`graph._GraphBase`): every propagation is
gather → scale → ``index_add_``. The self-supervised terms are methods
that return loss terms (SGL's ``ssl_loss``, NCL's ``structural_loss`` and
``prototype_loss``) for the caller's loop to add to the matching loss, as
in JAX.

SGL's two edge-dropout views draw their keep-masks from the dropout
generator the trainer hands out (the module ``edge_drop``), Philox, not
JAX's stream; ``ssl_loss(batch, masks=...)`` takes given masks instead.
DGCF's per-intent softmax over each node's edges is a ``scatter_reduce``
('amax', the maximum taken without its gradient: the softmax does not
depend on it) and two ``index_add_`` sums: JAX's ``segment_max`` /
``segment_sum``. `kmeans_prototypes` is JAX's numpy, draw for draw. The
parameters carry flax's names (``emb_user``, ``emb_item``,
``emb_item_ctx``, ``filter<k>``, ``enc_u``, ``enc_i``, ``decoder_q``).
GCMC's ``decoder_q`` is orthogonal, drawn by `torch.nn.init.orthogonal_`
(the QR of a normal matrix, signs fixed by R's diagonal, as flax's
``orthogonal()``): the same distribution, another stream.

Under a mesh the tables row-shard as `graph`'s do: SGL, NCL, DGCF,
SpectralCF and GCMC gather them whole once a propagation and run their
hops on the whole tables (`_GraphBase._tables`); NCL's prototype term and
LINE, which read rows by id, read them through the mesh's exchange
(`parallel.mesh.lookup`). ``NCL.prototypes`` runs the k-means on the
gathered tables, so every rank gets the same centers. SGL's ``ssl_loss``
and NCL's ``structural_loss`` are sums over the batch's rows: under a mesh
each counts n_data times this rank's rows, so that the trainer's mean over
'data' leaves JAX's global-batch sum.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import _l2_normalize, similarity_scores
from recbox_tpu_torch.models.matching.graph import (
    LightGCN, _GraphBase, _table,
)
from recbox_tpu_torch.nn.attention import dense
from recbox_tpu_torch.nn.core import Dropout
from recbox_tpu_torch.parallel.mesh import data_shards, lookup

__all__ = ["SGL", "NCL", "DGCF", "SpectralCF", "GCMC", "LINE",
           "kmeans_prototypes", "infonce", "infonce_all"]


def infonce(a: torch.Tensor, b: torch.Tensor,
            tau: float = 0.2, offset: int = 0) -> torch.Tensor:
    """InfoNCE with in-batch negatives: row r of ``a`` against row
    ``offset + r`` of ``b`` (``b`` may hold more rows: under a mesh the
    global batch's, this rank's rows from ``offset``)."""
    logits = _l2_normalize(a) @ _l2_normalize(b).T / tau
    logp = F.log_softmax(logits, dim=-1)
    if offset == 0 and logits.shape[0] == logits.shape[1]:
        return torch.mean(-torch.diagonal(logp))
    rows = torch.arange(logits.shape[0], device=logits.device)
    return torch.mean(-logp[rows, offset + rows])


def infonce_all(a: torch.Tensor, b: torch.Tensor, b_all: torch.Tensor,
                tau: float = 0.2) -> torch.Tensor:
    """InfoNCE whose denominator runs over every node of the second view
    (``b_all``), summed over the batch (SGL / NCL's reference semantics)."""
    a, b, b_all = _l2_normalize(a), _l2_normalize(b), _l2_normalize(b_all)
    pos = torch.sum(a * b, dim=1) / tau
    ttl = torch.logsumexp(a @ b_all.T / tau, dim=1)
    return torch.sum(ttl - pos)


def kmeans_prototypes(emb: np.ndarray, k: int, n_iters: int = 20,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host k-means (NCL's E-step) with k-means++ seeding: (centers (k, D),
    assignments (N,)), JAX's numpy step for step."""
    rng = np.random.default_rng(seed)
    e2 = (emb ** 2).sum(-1, keepdims=True)
    centers = np.empty((k, emb.shape[1]), dtype=emb.dtype)
    centers[0] = emb[rng.integers(len(emb))]
    d2 = ((emb - centers[0]) ** 2).sum(-1)
    for j in range(1, k):
        s = float(d2.sum())
        # every point on a chosen center: draw uniformly
        p = d2 / s if s > 0 else np.full(len(emb), 1.0 / len(emb))
        centers[j] = emb[rng.choice(len(emb), p=p)]
        d2 = np.minimum(d2, ((emb - centers[j]) ** 2).sum(-1))
    for _ in range(n_iters):
        # ||e - c||² through one (N, k) product, not an (N, k, D) tensor
        d = e2 - 2.0 * emb @ centers.T + (centers ** 2).sum(-1)[None, :]
        assign = d.argmin(1)
        for j in range(k):
            sel = emb[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return centers, assign


def _segment_softmax(logits: torch.Tensor, segments: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Softmax of (E, K) ``logits`` over the edges of each segment, per
    column."""
    idx = segments[:, None].expand_as(logits)
    m = logits.new_full((num_segments, logits.shape[1]), float("-inf")) \
        .scatter_reduce(0, idx, logits.detach(), "amax")
    e = torch.exp(logits - m.index_select(0, segments))
    z = logits.new_zeros(num_segments, logits.shape[1]).index_add_(
        0, segments, e)
    return e / torch.clamp(z.index_select(0, segments), min=1e-12)


class SGL(LightGCN):
    """Self-supervised graph learning: LightGCN and InfoNCE between two
    edge-dropout views of the propagated embeddings."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 ssl_tau: float = 0.2, drop_ratio: float = 0.1, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        self.ssl_tau, self.drop_ratio = float(ssl_tau), float(drop_ratio)
        self.edge_drop = Dropout(self.drop_ratio)

    def _propagate_with_mask(self, edge_keep: Optional[torch.Tensor]):
        coefs = None
        if edge_keep is not None:
            coefs = self.edge_coefs * edge_keep / (1.0 - self.drop_ratio)
        return self.propagated(coefs=coefs)

    def ssl_loss(self, batch,
                 masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """InfoNCE over two dropout views: the anchors are the batch's
        users and positive items, the denominator every node of view 2.
        ``masks`` (two (E,) keep-masks) replaces the draws. A sum over the
        batch's rows: under a mesh, n_data times this rank's (`parallel.
        mesh.data_shards`), so that ``bpr(o) + model.ssl_loss(b)`` trains
        JAX's sharded objective."""
        if masks is None:
            n = self.edge_users.shape[0]
            dev = self.edge_users.device
            masks = (self.edge_drop.keep_mask((n,), dev),
                     self.edge_drop.keep_mask((n,), dev))
        u1, i1 = self._propagate_with_mask(masks[0].to(torch.float32))
        u2, i2 = self._propagate_with_mask(masks[1].to(torch.float32))
        users = batch[self.feature_map.query_index].reshape(-1)
        pos = batch["__item_ids__"][:, 0]
        return data_shards(self) * (
            infonce_all(u1[users], u2[users], u2, self.ssl_tau)
            + infonce_all(i1[pos], i2[pos], i2, self.ssl_tau))


class NCL(LightGCN):
    """Neighbourhood-enriched contrastive learning: LightGCN, a structural
    contrast (hop 2h against hop 0 of the same node) and a prototype
    contrast against k-means centers the caller refreshes."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 ssl_tau: float = 0.1, hyper_layers: int = 1, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        self.ssl_tau, self.hyper_layers = float(ssl_tau), int(hyper_layers)

    def layer_outputs(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        ue, ie = self._tables()
        user_layers, item_layers = [ue], [ie]
        for _ in range(max(self.n_layers, 2 * self.hyper_layers)):
            ue, ie = self._propagate_hop(ue, ie)
            user_layers.append(ue)
            item_layers.append(ie)
        return user_layers, item_layers

    def structural_loss(self, batch) -> torch.Tensor:
        """Hop 2h against hop 0 of the batch's users and positive items,
        the denominator every node: a sum over the batch's rows, n_data
        times this rank's under a mesh, as SGL's ``ssl_loss``."""
        ul, il = self.layer_outputs()
        users = batch[self.feature_map.query_index].reshape(-1)
        pos = batch["__item_ids__"][:, 0]
        k = 2 * self.hyper_layers
        return data_shards(self) * (
            infonce_all(ul[k][users], ul[0][users], ul[0], self.ssl_tau)
            + infonce_all(il[k][pos], il[0][pos], il[0], self.ssl_tau))

    def prototype_loss(self, batch, user_protos, item_protos, user_assign,
                       item_assign) -> torch.Tensor:
        """Each node against its k-means prototype (ProtoNCE); centers and
        assignments from `kmeans_prototypes`."""
        users = batch[self.feature_map.query_index].reshape(-1)
        pos = batch["__item_ids__"][:, 0]
        dev = self.emb_user.device

        def proto_nce(emb, protos, assign):
            protos = torch.as_tensor(protos, device=dev)
            logits = _l2_normalize(emb) @ _l2_normalize(protos).T \
                / self.ssl_tau
            rows = torch.arange(emb.shape[0], device=dev)
            return torch.mean(-F.log_softmax(logits, dim=-1)[rows, assign])

        ua = torch.as_tensor(np.asarray(user_assign), device=dev)
        ia = torch.as_tensor(np.asarray(item_assign), device=dev)
        return (proto_nce(lookup(self.emb_user, users), user_protos,
                          ua[users])
                + proto_nce(lookup(self.emb_item, pos), item_protos,
                            ia[pos]))

    @torch.no_grad()
    def prototypes(self, k: int, n_iters: int = 20, seed: int = 0):
        """NCL's E-step: `kmeans_prototypes` of the user and of the item
        table, (user centers, item centers, user assignments, item
        assignments) for ``prototype_loss``. Under a mesh the tables are
        gathered whole first (a collective: every rank calls it), and
        every rank computes the same prototypes."""
        ue, ie = (t.float().cpu().numpy() for t in self._tables())
        (up, ua), (ip, ia) = (kmeans_prototypes(e, k, n_iters, seed)
                              for e in (ue, ie))
        return up, ip, ua, ia


class DGCF(_GraphBase):
    """Disentangled GCF: the embedding splits into K intent chunks; each
    intent's edge weights are refined by ``n_routing`` routing rounds
    (softmax over each receiving node's edges), each intent propagating on
    its own. The routing logits carry over from layer to layer, as in
    JAX."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 n_intents: int = 4, n_routing: int = 2, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        self.n_intents, self.n_routing = int(n_intents), int(n_routing)

    def propagated(self) -> Tuple[torch.Tensor, torch.Tensor]:
        k, d = self.n_intents, self.embedding_dim
        u, i = self.edge_users, self.edge_items
        nu, ni = self.num_users, self.num_items
        ue, ie = self._tables()
        out_u = ue.reshape(nu, k, d // k)
        out_i = ie.reshape(ni, k, d // k)
        logits = out_u.new_zeros(u.shape[0], k)
        for _ in range(self.n_layers):
            hu, hi = out_u, out_i
            hu_e, hi_e = hu.index_select(0, u), hi.index_select(0, i)
            for _ in range(self.n_routing):
                w_u = _segment_softmax(logits, u, nu)
                w_i = _segment_softmax(logits, i, ni)
                msg_u = hu.new_zeros(hu.shape).index_add_(
                    0, u, hi_e * w_u[..., None])
                msg_i = hi.new_zeros(hi.shape).index_add_(
                    0, i, hu_e * w_i[..., None])
                logits = logits \
                    + torch.sum(torch.tanh(msg_u.index_select(0, u)) * hi_e,
                                dim=-1) \
                    + torch.sum(torch.tanh(msg_i.index_select(0, i)) * hu_e,
                                dim=-1)
            out_u, out_i = out_u + msg_u, out_i + msg_i
        return out_u.reshape(nu, d), out_i.reshape(ni, d)


class SpectralCF(_GraphBase):
    """Spectral CF: e_{l+1} = σ((e_l + Â e_l) W_l), the layer outputs
    concatenated (the eigen-free (I + Â) form)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        for k in range(self.n_layers):
            lin = nn.Linear(embedding_dim, embedding_dim, bias=False,
                            device=self.emb_user.device)
            with torch.no_grad():
                lin.weight.normal_(0.0, 0.01, generator=self._generator)
            setattr(self, f"filter{k}", lin)

    def propagated(self) -> Tuple[torch.Tensor, torch.Tensor]:
        ue, ie = self._tables()
        user_layers, item_layers = [ue], [ie]
        for k in range(self.n_layers):
            f = getattr(self, f"filter{k}")
            su, si = self._propagate_hop(ue, ie)
            ue = torch.sigmoid(f(ue + su))
            ie = torch.sigmoid(f(ie + si))
            user_layers.append(ue)
            item_layers.append(ie)
        return torch.cat(user_layers, dim=-1), torch.cat(item_layers, dim=-1)


class GCMC(_GraphBase):
    """Graph convolutional matrix completion (binary ratings): one
    message-passing hop, a dense encoder per side, and the bilinear
    decoder h_uᵀ Q h_i folded into the user tower so retrieval stays a
    dot product. The tables are normal(0.01) whatever
    ``emb_init_scheme``."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 hidden_dim: int = 64, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        g, dev = self._generator, self.emb_user.device
        with torch.no_grad():
            self.emb_user.normal_(0.0, 0.01, generator=g)
            self.emb_item.normal_(0.0, 0.01, generator=g)
        self.enc_u = dense(embedding_dim, hidden_dim, g, dev)
        self.enc_i = dense(embedding_dim, hidden_dim, g, dev)
        self.decoder_q = nn.Parameter(torch.empty(hidden_dim, hidden_dim,
                                                  device=dev))
        with torch.no_grad():
            nn.init.orthogonal_(self.decoder_q, generator=g)

    def encoded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        su, si = self._propagate_hop(*self._tables())
        hu = self.enc_u(torch.relu(su))
        hi = self.enc_i(torch.relu(si))
        return hu @ self.decoder_q, hi

    propagated = encoded


class LINE(_GraphBase):
    """LINE: first-order ⟨u, i⟩ scores on the vertex tables (serving
    always reads them); ``order`` 2 adds ⟨u, ctx_i⟩ on a context table in
    training only, the two logits summed into the one pairwise
    objective."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 order: int = 2, **kwargs):
        super().__init__(feature_map, embedding_dim, **kwargs)
        self.order = int(order)
        if self.order == 2:
            self.emb_item_ctx = _table(self.num_items, embedding_dim,
                                       self.emb_init_scheme, self._generator,
                                       self.emb_item.device)

    def user_tower(self, batch):
        return lookup(self.emb_user,
                      batch[self.feature_map.query_index].reshape(-1))

    def item_tower(self, batch):
        return lookup(self.emb_item,
                      batch[self.feature_map.corpus_index].reshape(-1))

    def forward(self, batch):
        user_emb = self.user_tower(batch)
        ids = batch["__item_ids__"]
        flat = ids.reshape(-1)
        scores = similarity_scores(user_emb, lookup(self.emb_item, flat),
                                   ids.shape[1], self.similarity,
                                   self.temperature)
        if self.order == 2:
            scores = scores + similarity_scores(
                user_emb, lookup(self.emb_item_ctx, flat), ids.shape[1],
                self.similarity, self.temperature)
        return scores
