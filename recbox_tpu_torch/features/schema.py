"""Feature schema: typed specs for every input feature and the dataset map.

Own copy of `recbox_tpu/features/schema.py` (:39-204): the feature types,
`FeatureSpec` (`table_name`, `to_dict`), and the `FeatureMap` fields,
lookups (`labels`, `by_type`, `by_source`, `input_features`,
`num_fields`, `sum_emb_out_dim`, `feature_dict`) and JSON persistence
(`to_json`, `save`, `load`, `from_dict`, `replace`, JAX :165-203). The
file format is JAX's byte for byte: the specs carry JAX's fields in JAX's
order, so a ``feature_map.json`` either package writes loads in the other.
``pretrain_path`` and ``freeze_emb`` are read by
`nn.embedding.FeatureEmbedding` (a pretrained table, no gradient to the
table); ``shard_table`` is the table's mesh placement, which
`nn.embedding.FeatureEmbedding` reads under a mesh (`parallel/`). A
numeric feature is one scalar column, embedded as value × a learned (1, d)
vector by `nn.embedding.FeatureEmbedding`, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Mapping, Optional, Tuple

__all__ = ["CATEGORICAL", "NUMERIC", "SEQUENCE", "META", "FeatureSpec",
           "FeatureMap", "auto_embedding_dim"]

CATEGORICAL = "categorical"
NUMERIC = "numeric"
SEQUENCE = "sequence"
META = "meta"

_VALID_TYPES = (CATEGORICAL, NUMERIC, SEQUENCE, META)


def auto_embedding_dim(vocab_size: int) -> int:
    """Heuristic width 6·⌈vocab^0.25⌉ (rechub `utils/data.py:85-97`),
    rounded up to a multiple of 8, as JAX's `schema.py:29` rounds it (the
    encoder's ``embedding_dim='auto'``)."""
    dim = 6 * math.ceil(max(1, vocab_size) ** 0.25)
    return ((dim + 7) // 8) * 8


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
      pretrain_path, freeze_emb: a pretrained table (a local .npy / .npz)
        and whether it trains.
      pooling: sequence pooling, 'mean' | 'sum' | 'concat' | 'none'.
      shard_table: the per-table mesh placement: False replicates the
        table, True row-shards it, None leaves it to the module.
    """

    name: str
    type: str = CATEGORICAL
    source: str = ""
    vocab_size: int = 0
    embedding_dim: int = 0
    max_len: int = 0
    share_embedding: Optional[str] = None
    padding_idx: Optional[int] = None
    pretrain_path: Optional[str] = None
    freeze_emb: bool = False
    pooling: str = "mean"
    shard_table: Optional[bool] = None

    def __post_init__(self):
        if self.type not in _VALID_TYPES:
            raise ValueError(f"feature {self.name}: invalid type {self.type!r}")
        if self.type == SEQUENCE and self.max_len <= 0:
            raise ValueError(f"sequence feature {self.name} needs max_len > 0")

    @property
    def table_name(self) -> str:
        return self.share_embedding or self.name

    def to_dict(self) -> dict:
        """The non-default fields (name, type, vocab_size and embedding_dim
        always; ``shard_table`` whenever it is not None), JAX's rule."""
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items()
                if v not in (None, "", 0, False)
                or k in ("name", "type", "vocab_size", "embedding_dim")
                or (k == "shard_table" and v is not None)}


@dataclasses.dataclass(frozen=True)
class FeatureMap:
    """Dataset-level schema: an ordered tuple of FeatureSpecs plus the
    task wiring: label columns, the matching query / corpus index columns,
    group id, item and sample counts (fields in the JAX package's order)."""

    dataset_id: str
    features: Tuple[FeatureSpec, ...]
    labels: Tuple[str, ...] = ()
    query_index: str = ""
    corpus_index: str = ""
    group_id: str = ""
    num_items: int = 0
    num_samples: int = 0

    def __post_init__(self):
        names = [f.name for f in self.features]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate feature names in {self.dataset_id}")

    @property
    def feature_dict(self) -> Mapping[str, FeatureSpec]:
        return {f.name: f for f in self.features}

    def __getitem__(self, name: str) -> FeatureSpec:
        return self.feature_dict[name]

    def by_type(self, ftype: str) -> Tuple[FeatureSpec, ...]:
        return tuple(f for f in self.features if f.type == ftype)

    def by_source(self, source: str) -> Tuple[FeatureSpec, ...]:
        """Features routed to a tower; '' (unset) features go to every tower."""
        return tuple(f for f in self.features
                     if f.source in (source, "") and f.type != META)

    @property
    def input_features(self) -> Tuple[FeatureSpec, ...]:
        return tuple(f for f in self.features if f.type != META)

    @property
    def num_fields(self) -> int:
        return len(self.input_features)

    def sum_emb_out_dim(self, source: Optional[str] = None) -> int:
        """Total embedded width (a 'concat' sequence counts max_len times)."""
        feats = self.input_features if source is None \
            else self.by_source(source)
        return sum(f.embedding_dim * f.max_len
                   if f.type == SEQUENCE and f.pooling == "concat"
                   else f.embedding_dim for f in feats)

    # -- persistence ---------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "dataset_id": self.dataset_id,
            "features": [f.to_dict() for f in self.features],
            "labels": list(self.labels),
            "query_index": self.query_index,
            "corpus_index": self.corpus_index,
            "group_id": self.group_id,
            "num_items": self.num_items,
            "num_samples": self.num_samples,
        }, indent=2)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "FeatureMap":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureMap":
        return cls(
            dataset_id=d["dataset_id"],
            features=tuple(FeatureSpec(**fd) for fd in d["features"]),
            labels=tuple(d.get("labels", ())),
            query_index=d.get("query_index", ""),
            corpus_index=d.get("corpus_index", ""),
            group_id=d.get("group_id", ""),
            num_items=d.get("num_items", 0),
            num_samples=d.get("num_samples", 0),
        )

    def replace(self, **kw) -> "FeatureMap":
        return dataclasses.replace(self, **kw)
