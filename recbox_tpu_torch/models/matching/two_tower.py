"""Two-tower matching models: MF, DSSM, YoutubeDNN.

Counterparts of `recbox_tpu/models/matching/two_tower.py`:
  - MF: pure embedding towers, each the sum of its features' embeddings;
  - DSSM: an MLP over each tower's concatenated features;
  - YoutubeDNN: user tower = MLP over [pooled history ⊕ user features],
    item tower = the item embedding.

Submodule names (``user_embedding``, ``item_embedding``, ``user_mlp``,
``item_mlp``) are the flax ones, so `interop.from_jax_params` maps a JAX
param tree onto them; the embedding modules carry the flax names as their
``path`` too, so their table keys (``item_embedding/emb_item_id``) and
`__rows__` keys are the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import MatchingModel
from recbox_tpu_torch.nn.core import MLP
from recbox_tpu_torch.nn.embedding import FeatureEmbedding, concat_embeddings

__all__ = ["MF", "DSSM", "YoutubeDNN"]

Device = Optional[Union[str, torch.device]]


def _sum_features(embs, feats):
    return sum(embs[f.name] for f in feats if f.name in embs)


class MF(MatchingModel):
    """Matrix factorization: user/item id embeddings, dot or cosine scores."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        kw = dict(embedding_dim=embedding_dim,
                  emb_init_scheme=emb_init_scheme, generator=g, device=dev)
        self.user_embedding = FeatureEmbedding(
            feature_map, source="user", name="user_embedding", **kw)
        self.item_embedding = FeatureEmbedding(
            feature_map, source="item", name="item_embedding", **kw)

    def user_tower(self, batch):
        return _sum_features(self.user_embedding(batch),
                             self.feature_map.by_source("user"))

    def item_tower(self, batch):
        return _sum_features(self.item_embedding(batch),
                             self.feature_map.by_source("item"))


class DSSM(MatchingModel):
    """Deep structured semantic model: MLP over each tower's concat features."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 user_hidden_units: Sequence[int] = (256, 128, 64),
                 item_hidden_units: Sequence[int] = (256, 128, 64),
                 activation: str = "relu", dropout: float = 0.0,
                 batch_norm: bool = False,
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
                            user_hidden_units[:-1], activation=activation,
                            output_dim=user_hidden_units[-1], dropout=dropout,
                            batch_norm=batch_norm, generator=g, device=dev)
        self.item_mlp = MLP(self.item_embedding.out_dim,
                            item_hidden_units[:-1], activation=activation,
                            output_dim=item_hidden_units[-1], dropout=dropout,
                            batch_norm=batch_norm, generator=g, device=dev)

    def user_tower(self, batch):
        x = concat_embeddings(self.user_embedding(batch),
                              self.feature_map.by_source("user"))
        return self.user_mlp(x)

    def item_tower(self, batch):
        x = concat_embeddings(self.item_embedding(batch),
                              self.feature_map.by_source("item"))
        return self.item_mlp(x)


class YoutubeDNN(MatchingModel):
    """YoutubeDNN retrieval: deep user tower vs. plain item embedding.

    The item tower is the item-id embedding so user vectors and the corpus
    live in one space; history sequences (sharing the item-id table) are
    mean-pooled into the user tower's input.
    """

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0,
                 hidden_units: Sequence[int] = (256, 128, 64),
                 activation: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        g, dev = self.init_rng(generator, device)
        self.user_embedding = FeatureEmbedding(
            feature_map, source="user", embedding_dim=embedding_dim,
            name="user_embedding", generator=g, device=dev)
        self.item_embedding = FeatureEmbedding(
            feature_map, source="item", embedding_dim=embedding_dim,
            name="item_embedding", generator=g, device=dev)
        self.user_mlp = MLP(self.user_embedding.out_dim, hidden_units[:-1],
                            activation=activation, output_dim=embedding_dim,
                            dropout=dropout, generator=g, device=dev)

    def user_tower(self, batch):
        x = concat_embeddings(self.user_embedding(batch),
                              self.feature_map.by_source("user"))
        return self.user_mlp(x)

    def item_tower(self, batch):
        return _sum_features(self.item_embedding(batch),
                             self.feature_map.by_source("item"))
