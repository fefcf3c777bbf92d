"""Feature schema: typed specs for every input feature and the dataset map.

Own copy of the part of `recbox_tpu/features/schema.py` that the retrieval
serving slice reads: the feature types, `FeatureSpec.table_name`, and
`FeatureMap.by_source` / `input_features` / `feature_dict`. Fields the slice
never reads (pretrained tables, frozen tables, table placement, JSON
persistence) wait for the slices that need them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

__all__ = ["CATEGORICAL", "NUMERIC", "SEQUENCE", "META", "FeatureSpec",
           "FeatureMap"]

CATEGORICAL = "categorical"
NUMERIC = "numeric"
SEQUENCE = "sequence"
META = "meta"

_VALID_TYPES = (CATEGORICAL, NUMERIC, SEQUENCE, META)


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Schema of one input feature.

    Attributes:
      name: key in the batch dict.
      type: 'categorical' | 'numeric' | 'sequence' | 'meta' ('meta'
        columns pass through untouched).
      source: tower tag ('user' / 'item' / 'context'); '' goes to every
        tower.
      vocab_size: embedding rows incl. OOV (index 0) and PAD (last index).
      embedding_dim: width of the embedding (or of the numeric projection).
      max_len: padded length of a sequence feature.
      share_embedding: name of the feature whose table this one reuses.
      padding_idx: id whose embedding is masked to zeros; None disables
        (a sequence feature then pads with ``vocab_size - 1``).
      pooling: sequence pooling, 'mean' | 'sum' | 'concat' | 'none'.
    """

    name: str
    type: str = CATEGORICAL
    source: str = ""
    vocab_size: int = 0
    embedding_dim: int = 0
    max_len: int = 0
    share_embedding: Optional[str] = None
    padding_idx: Optional[int] = None
    pooling: str = "mean"

    def __post_init__(self):
        if self.type not in _VALID_TYPES:
            raise ValueError(f"feature {self.name}: invalid type {self.type!r}")
        if self.type == SEQUENCE and self.max_len <= 0:
            raise ValueError(f"sequence feature {self.name} needs max_len > 0")

    @property
    def table_name(self) -> str:
        return self.share_embedding or self.name


@dataclasses.dataclass(frozen=True)
class FeatureMap:
    """Dataset-level schema: an ordered tuple of FeatureSpecs plus the
    matching wiring (query / corpus index columns, item count)."""

    dataset_id: str
    features: Tuple[FeatureSpec, ...]
    query_index: str = ""
    corpus_index: str = ""
    num_items: int = 0

    def __post_init__(self):
        names = [f.name for f in self.features]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate feature names in {self.dataset_id}")

    @property
    def feature_dict(self) -> Mapping[str, FeatureSpec]:
        return {f.name: f for f in self.features}

    def __getitem__(self, name: str) -> FeatureSpec:
        return self.feature_dict[name]

    def by_source(self, source: str) -> Tuple[FeatureSpec, ...]:
        """Features routed to a tower; '' (unset) features go to every tower."""
        return tuple(f for f in self.features
                     if f.source in (source, "") and f.type != META)

    @property
    def input_features(self) -> Tuple[FeatureSpec, ...]:
        return tuple(f for f in self.features if f.type != META)
