"""Item2Vec: skip-gram with negative sampling over item co-occurrence.

Counterpart of `recbox_tpu/models/matching/item2vec.py`: items that occur
within ``window`` of each other in a user's list are (center, context)
pairs (`build_skipgram_pairs`, JAX's numpy draw for draw); the SGNS loss
trains a center and a context table (flax's ``emb_center`` /
``emb_context``, normal(0.05)); a user's retrieval vector is the mean of
the history's center vectors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.models.base import init_rng
from recbox_tpu_torch.nn.core import normal_table
from recbox_tpu_torch.parallel.mesh import lookup, whole_table

__all__ = ["Item2Vec", "sgns_loss", "build_skipgram_pairs"]


def build_skipgram_pairs(user_items: Dict[int, list], window: int = 2,
                         max_pairs: int = 200_000,
                         seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(center, context) int32 pairs within ``window`` of each other in
    each user's list, subsampled to ``max_pairs`` without replacement."""
    rng = np.random.default_rng(seed)
    centers, contexts = [], []
    for items in user_items.values():
        arr = np.asarray(items)
        n = len(arr)
        for i in range(n):
            for j in range(max(0, i - window), min(n, i + window + 1)):
                if j != i:
                    centers.append(arr[i])
                    contexts.append(arr[j])
    centers = np.asarray(centers, np.int32)
    contexts = np.asarray(contexts, np.int32)
    if len(centers) > max_pairs:
        sel = rng.choice(len(centers), max_pairs, replace=False)
        centers, contexts = centers[sel], contexts[sel]
    return centers, contexts


class Item2Vec(nn.Module):
    """SGNS item embeddings: `pair_logits` trains them, `user_vector` and
    `item_vectors` serve."""

    init_rng = staticmethod(init_rng)

    def __init__(self, num_items: int, embedding_dim: int = 64,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        g, dev = self.init_rng(generator, device)
        self.num_items, self.embedding_dim = num_items, embedding_dim
        self.emb_center = normal_table((num_items, embedding_dim), 0.05, g,
                                       dev, shard=True)
        self.emb_context = normal_table((num_items, embedding_dim), 0.05, g,
                                        dev, shard=True)


    def forward(self, batch):
        return self.pair_logits(batch["center"], batch["context"],
                                batch["neg"])

    def pair_logits(self, center, context, neg
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,) positive logits and (B, N) negative logits."""
        c = lookup(self.emb_center, center, embedding=True)
        pos = torch.sum(c * lookup(self.emb_context, context,
                                   embedding=True), dim=-1)
        negs = torch.einsum("bd,bnd->bn", c,
                            lookup(self.emb_context, neg, embedding=True))
        return pos, negs

    def item_vectors(self) -> torch.Tensor:
        """The center table (gathered whole under a mesh)."""
        return whole_table(self.emb_center)

    def user_vector(self, hist: torch.Tensor) -> torch.Tensor:
        """Mean of the history's center vectors; ``hist`` (B, L) padded
        with 0."""
        emb = lookup(self.emb_center, hist, embedding=True)
        mask = (hist != 0).to(emb.dtype)[..., None]
        return torch.sum(emb * mask, dim=1) / torch.clamp(
            torch.sum(mask, dim=1), min=1e-12)


def sgns_loss(pos_neg) -> torch.Tensor:
    """−log σ(pos) − Σ log σ(−neg), averaged over the pairs."""
    pos, negs = pos_neg
    return torch.mean(-F.logsigmoid(pos)
                      - torch.sum(F.logsigmoid(-negs), dim=-1))
