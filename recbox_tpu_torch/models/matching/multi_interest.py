"""Multi-interest and contrastive matching models: MIND, ComiRec, SimpleX,
YoutubeSBC.

Counterpart of `recbox_tpu/models/matching/multi_interest.py`:
  - MIND: capsule dynamic routing (`nn.attention.CapsuleNetwork`) gives K
    interest vectors; a training batch scores its candidates with one user
    vector, the interests weighted by softmax(|x|^p · sign(x)) of their
    scores against the positive (column 0) alone;
  - ComiRec-SA: the self-attentive extractor (`MultiInterestSA`), trained
    the same way;
  - SimpleX: user = g · id embedding + (1 − g) · mean(history), cosine;
  - YoutubeSBC: in-batch sampled softmax with log-q correction
    (``train_method='inbatch_scores'`` with
    `sampled_softmax_inbatch_loss`); under a mesh the negatives are the
    global batch's items, as under JAX's sharded trainer.

`user_tower` of MIND / ComiRec returns (B, K, D): `RetrievalService.query`
searches each interest and merges by max score, and the retrieval
evaluator takes the max over K of the (B, K, N) scores. The tables are
flax's ``emb_item`` / ``emb_user`` (normal(1e-4)); the extractors are the
modules ``capsule`` and ``sa``, so `interop.from_jax_params` maps a JAX
param tree onto them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import MatchingModel, extract_item_batch
from recbox_tpu_torch.nn.attention import CapsuleNetwork, MultiInterestSA
from recbox_tpu_torch.nn.core import MLP, normal_table
from recbox_tpu_torch.nn.embedding import FeatureEmbedding, concat_embeddings
from recbox_tpu_torch.parallel.mesh import (
    DATA_AXIS, all_gather, inbatch_columns, inbatch_layout, lookup,
    mark_inbatch, module_mesh,
)

__all__ = ["MIND", "ComiRec", "SimpleX", "YoutubeSBC",
           "sampled_softmax_inbatch_loss"]

Device = Optional[Union[str, torch.device]]


def sampled_softmax_inbatch_loss(scores: torch.Tensor,
                                 log_q: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """In-batch softmax CE on the diagonal of (B, B) ``scores``, each
    column's ``log_q`` subtracted first.

    Under a mesh, ``scores`` from ``YoutubeSBC.inbatch_scores`` are this
    rank's rows against the global batch's columns
    (`parallel.mesh.mark_inbatch`): each row's positive sits at this rank's
    offset, and a ``log_q`` of this rank's rows is all-gathered over 'data'
    to cover the global batch's columns, so the loss written as JAX writes
    it is this rank's rows' mean of JAX's global-batch CE."""
    layout = inbatch_layout(scores)
    if layout is None:
        if log_q is not None:
            scores = scores - log_q[None, :]
        return -torch.mean(torch.diagonal(F.log_softmax(scores, dim=1)))
    mesh, offset = layout
    if log_q is not None:
        if log_q.shape[0] != scores.shape[1]:
            log_q = all_gather(log_q.contiguous(), mesh, DATA_AXIS)
        scores = scores - log_q[None, :]
    rows = torch.arange(scores.shape[0], device=scores.device)
    return -torch.mean(F.log_softmax(scores, dim=1)[rows, offset + rows])


class _MultiInterestBase(MatchingModel):
    """The item table, the history's embedding and the interest scoring."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 max_seq_len: int = 50, interest_num: int = 4,
                 pow_p: float = 2.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        self.max_seq_len, self.interest_num = max_seq_len, interest_num
        self.pow_p = float(pow_p)
        spec = feature_map[feature_map.corpus_index]
        self.emb_item = normal_table((spec.vocab_size, embedding_dim), 1e-4,
                                     g, dev, shard=True)
        self._make_extractor(g, dev)

    def _make_extractor(self, generator, device) -> None:
        raise NotImplementedError

    @property
    def extractor(self) -> nn.Module:
        raise NotImplementedError

    def _history(self, batch):
        seq = batch["item_seq"]
        emb = lookup(self.emb_item, seq, embedding=True)
        mask = seq != 0
        return emb * mask[..., None].to(emb.dtype), mask

    def interests(self, batch) -> torch.Tensor:
        """(B, K, D) interest vectors of the batch's histories."""
        return self.extractor(*self._history(batch))

    def user_tower(self, batch):
        return self.interests(batch)

    def item_tower(self, batch):
        return lookup(self.emb_item, batch[self.feature_map.corpus_index],
                      embedding=True)

    def forward(self, batch):
        """(B, 1 + negs) scores: the interests attended by their scores
        against the positive (column 0) only, as the reference picks its
        interest by the label item; every candidate is scored by that one
        user vector."""
        interests = self.interests(batch)
        item_emb = self.item_tower(extract_item_batch(batch))
        s = batch["__item_ids__"].shape[1]
        item_emb = item_emb.reshape(-1, s, self.embedding_dim)
        pos_logits = torch.einsum("bkd,bd->bk", interests, item_emb[:, 0, :])
        att = torch.softmax(torch.pow(torch.abs(pos_logits), self.pow_p)
                            * torch.sign(pos_logits), dim=1)
        user_vec = torch.einsum("bk,bkd->bd", att, interests)
        return torch.einsum("bd,bsd->bs", user_vec, item_emb) \
            / self.temperature


class MIND(_MultiInterestBase):
    """Capsule dynamic-routing multi-interest extractor."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 routing_rounds: int = 3, **kwargs):
        self.routing_rounds = routing_rounds
        super().__init__(feature_map, embedding_dim, **kwargs)

    def _make_extractor(self, generator, device) -> None:
        self.capsule = CapsuleNetwork(self.embedding_dim, self.interest_num,
                                      self.routing_rounds, generator, device)

    @property
    def extractor(self) -> nn.Module:
        return self.capsule


class ComiRec(_MultiInterestBase):
    """Self-attentive multi-interest extractor (ComiRec-SA)."""

    def _make_extractor(self, generator, device) -> None:
        self.sa = MultiInterestSA(self.embedding_dim, self.interest_num,
                                  generator=generator, device=device)

    @property
    def extractor(self) -> nn.Module:
        return self.sa


class SimpleX(MatchingModel):
    """User = g · id embedding + (1 − g) · mean of the history's item
    embeddings (the id embedding alone without ``item_seq``); cosine
    similarity by default."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "cosine", temperature: float = 1.0,
                 gamma: float = 0.5, max_seq_len: int = 50,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        self.gamma, self.max_seq_len = float(gamma), max_seq_len
        rows = (feature_map[feature_map.query_index].vocab_size,
                feature_map[feature_map.corpus_index].vocab_size)
        self.emb_user = normal_table((rows[0], embedding_dim), 1e-4, g, dev,
                                     shard=True)
        self.emb_item = normal_table((rows[1], embedding_dim), 1e-4, g, dev,
                                     shard=True)

    def user_tower(self, batch):
        ue = lookup(self.emb_user, batch[self.feature_map.query_index],
                    embedding=True)
        if "item_seq" not in batch:
            return ue
        seq = batch["item_seq"]
        emb = lookup(self.emb_item, seq, embedding=True)
        mask = (seq != 0).to(emb.dtype)[..., None]
        hist = torch.sum(emb * mask, dim=1) / torch.clamp(
            torch.sum(mask, dim=1), min=1e-9)
        return self.gamma * ue + (1.0 - self.gamma) * hist

    def item_tower(self, batch):
        return lookup(self.emb_item, batch[self.feature_map.corpus_index],
                      embedding=True)


class YoutubeSBC(MatchingModel):
    """Sampled-softmax bias-corrected two towers, trained on in-batch
    negatives: ``inbatch_scores`` gives the (B, B) user · item scores of a
    batch (the diagonal its positives) for `sampled_softmax_inbatch_loss`
    with the batch's log sampling probabilities."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 user_hidden_units: Sequence[int] = (128, 64),
                 item_hidden_units: Sequence[int] = (128, 64),
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        self.user_embedding = FeatureEmbedding(
            feature_map, source="user", name="user_embedding", generator=g,
            device=dev)
        self.item_embedding = FeatureEmbedding(
            feature_map, source="item", name="item_embedding", generator=g,
            device=dev)
        self.user_mlp = MLP(self.user_embedding.out_dim,
                            user_hidden_units[:-1],
                            output_dim=user_hidden_units[-1],
                            dropout=dropout, generator=g, device=dev)
        self.item_mlp = MLP(self.item_embedding.out_dim,
                            item_hidden_units[:-1],
                            output_dim=item_hidden_units[-1],
                            dropout=dropout, generator=g, device=dev)

    def user_tower(self, batch):
        return self.user_mlp(concat_embeddings(
            self.user_embedding(batch), self.feature_map.by_source("user")))

    def item_tower(self, batch):
        return self.item_mlp(concat_embeddings(
            self.item_embedding(batch), self.feature_map.by_source("item")))

    def inbatch_scores(self, batch) -> torch.Tensor:
        """(B, B) user · item scores of the batch, the positives on the
        diagonal. Under a mesh (`parallel.mesh.module_mesh`), as JAX's
        sharded step sees the global batch: this rank's users against the
        global batch's items (gathered over 'data', their gradient summed
        over 'data'), marked for `sampled_softmax_inbatch_loss`."""
        u = self.user_tower(batch)
        i = self.item_tower(batch)
        mesh = module_mesh(self)
        if mesh is None:
            return (u @ i.T).float() / self.temperature
        items, offset = inbatch_columns(i, mesh)
        return mark_inbatch((u @ items.T).float() / self.temperature, mesh,
                            offset)
