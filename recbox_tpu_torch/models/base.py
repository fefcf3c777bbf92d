"""Model bases: two towers and their similarity; the CTR ranking base.

Counterpart of `recbox_tpu/models/base.py` `MatchingModel`,
`similarity_scores` and `RankingModel`. Matching subclasses define
`user_tower` / `item_tower`; `encode_user` / `encode_item` are the serving
entry points (normalized when the model was trained with cosine
similarity), and `forward` scores a training batch's (B, 1+num_negs) sampled
items. Ranking subclasses define `logits(batch)`; `forward` returns them as
(B,) raw logits (the sigmoid belongs to the loss and the evaluator).

Every model draws its parameters from ``generator`` (default: a generator
on the model's device seeded with 0) on ``device`` (default: the CUDA
device, see `recbox_tpu_torch.resolve_device`); `init_rng` resolves the
pair.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.features.schema import FeatureMap

__all__ = ["MatchingModel", "RankingModel", "extract_item_batch",
           "init_rng", "similarity_scores"]

ITEM_PREFIX = "item::"


def init_rng(generator: Optional[torch.Generator],
             device: Optional[Union[str, torch.device]]
             ) -> Tuple[torch.Generator, torch.device]:
    """(generator, device) a model draws its parameters from."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return generator, dev


def extract_item_batch(batch: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Pull `item::`-prefixed features and flatten (B, S, ...) → (B·S, ...)."""
    return {k[len(ITEM_PREFIX):]: v.reshape((-1,) + tuple(v.shape[2:]))
            for k, v in batch.items() if k.startswith(ITEM_PREFIX)}


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def similarity_scores(user_emb: torch.Tensor, item_emb: torch.Tensor,
                      num_candidates: int, similarity: str = "dot",
                      temperature: float = 1.0) -> torch.Tensor:
    """(B, D) × (B·S, D) → (B, S) per-row candidate scores."""
    item_emb = item_emb.reshape(user_emb.shape[0], num_candidates, -1)
    if similarity == "cosine":
        user_emb = _l2_normalize(user_emb)
        item_emb = _l2_normalize(item_emb)
    scores = torch.einsum("bd,bsd->bs", user_emb, item_emb)
    return scores / temperature


class MatchingModel(nn.Module):
    """Two-tower base."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 similarity: str = "dot", temperature: float = 1.0):
        super().__init__()
        self.feature_map = feature_map
        self.embedding_dim = embedding_dim
        self.similarity = similarity
        self.temperature = temperature

    init_rng = staticmethod(init_rng)

    def user_tower(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def item_tower(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def _serve_normalize(self, emb: torch.Tensor) -> torch.Tensor:
        # cosine-trained models serve in cosine space too: the index ranks
        # by plain dot product of the encoded towers
        if self.similarity == "cosine":
            return _l2_normalize(emb)
        return emb

    def encode_user(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._serve_normalize(self.user_tower(batch))

    def encode_item(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._serve_normalize(self.item_tower(batch))

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        user_emb = self.user_tower(batch)
        item_emb = self.item_tower(extract_item_batch(batch))
        num_candidates = batch["__item_ids__"].shape[1]
        return similarity_scores(user_emb, item_emb, num_candidates,
                                 self.similarity, self.temperature)


class RankingModel(nn.Module):
    """CTR base: subclasses implement ``logits(batch) -> (B,)``; `forward`
    returns them flattened, as raw logits."""

    init_rng = staticmethod(init_rng)

    def __init__(self, feature_map: FeatureMap):
        super().__init__()
        self.feature_map = feature_map

    def logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.logits(batch).reshape(-1)
