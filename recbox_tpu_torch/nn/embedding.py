"""Feature embedding engine (torch.nn).

Counterpart of `recbox_tpu/nn/embedding.py` `FeatureEmbedding`,
`masked_pool`, `concat_embeddings`, `stack_embeddings` and the `__rows__`
protocol:

* one table per *table_name*, so `share_embedding` features alias one
  parameter; a table has as many rows as the largest vocab that uses it,
  so a shared sequence feature's PAD row may lie beyond the base vocab
  (`embedding.py:187-193`);
* categorical → row lookup, masked to zeros at ``padding_idx``;
  numeric → value × a learned (1, d) vector; sequence → lookup masked at
  the pad id (``padding_idx``, else ``vocab_size - 1``, `embedding.py:269`)
  then mean/sum pooling, concat, or the raw (B, L, D).

Tables live in ``tables[<table_name>]`` and numeric vectors in
``numeric[<feature>]``, the counterparts of flax's ``emb_<table>`` and
``num_<feature>`` params.

The `__rows__` protocol (`embedding.py:44-75`): when a batch carries
``rows_key_for(module.path, feature)``, the module uses those pre-gathered
rows instead of its table, so a trainer that gathers rows itself
(`training/packed.py`) gets (B, D) row gradients back. A module's ``path``
is its flax name (``("embedding",)``, ``("linear",)`` in DeepFM), so the
keys are the JAX package's. The block variant (`BLOCK_PREFIX`) is not
ported: it was opt-in and measured slower on the TPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import (
    CATEGORICAL, NUMERIC, SEQUENCE, FeatureMap, FeatureSpec,
)
from recbox_tpu_torch.nn.core import xavier_normal_, xavier_uniform_

__all__ = ["FeatureEmbedding", "concat_embeddings", "stack_embeddings",
           "masked_pool", "ROWS_PREFIX", "rows_key_for"]

ROWS_PREFIX = "__rows__"


def rows_key_for(module_path: Tuple[str, ...], feature_name: str) -> str:
    """Batch key of the pre-gathered rows of ``feature_name`` for the
    FeatureEmbedding at ``module_path``."""
    return ROWS_PREFIX + "/".join(module_path) + ":" + feature_name


def masked_pool(seq_emb: torch.Tensor, mask: torch.Tensor, mode: str
                ) -> torch.Tensor:
    """Pool (B, L, D) under a (B, L) validity mask ('mean' or 'sum')."""
    mask = mask.to(seq_emb.dtype)[..., None]
    summed = torch.sum(seq_emb * mask, dim=1)
    if mode == "sum":
        return summed
    if mode == "mean":
        counts = torch.clamp(torch.sum(mask, dim=1), min=1e-12)
        return summed / counts
    raise ValueError(f"unknown pooling mode {mode!r}")


class FeatureEmbedding(nn.Module):
    """Embeds a batch dict into {feature_name: (B, D) or (B, L, D)} tensors.

    Args:
      feature_map: schema.
      source: restrict to one tower ('user'/'item'); None embeds everything.
      embedding_dim: one width for every feature, overriding the specs.
      sequence_pooling: if False, sequence features stay (B, L, D).
      emb_init_scheme: 'normal' (std ``emb_init_std``), 'xavier_normal' or
        'xavier_uniform', the JAX package's table initializers.
      dtype: compute dtype of the outputs (tables stay float32).
      name: the module's flax name, '/'-joined when nested; it scopes the
        `__rows__` keys (``path``).
      generator: the torch.Generator every table draws from.
    """

    def __init__(self, feature_map: FeatureMap, source: Optional[str] = None,
                 embedding_dim: Optional[int] = None,
                 sequence_pooling: bool = True,
                 emb_init_scheme: str = "normal", emb_init_std: float = 1e-4,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if emb_init_scheme not in ("normal", "xavier_normal",
                                   "xavier_uniform"):
            raise NotImplementedError(
                f"emb_init_scheme={emb_init_scheme!r}: expected 'normal' | "
                "'xavier_normal' | 'xavier_uniform'")
        self.feature_map = feature_map
        self.source = source
        self.embedding_dim = embedding_dim
        self.sequence_pooling = sequence_pooling
        self.dtype = dtype
        self.path: Tuple[str, ...] = tuple(name.split("/")) if name else ()
        self.feats: Tuple[FeatureSpec, ...] = (
            feature_map.input_features if source is None
            else feature_map.by_source(source))
        self.tables = nn.ParameterDict()
        self.numeric = nn.ParameterDict()
        out_dim = 0
        for spec in self.feats:
            dim = embedding_dim or spec.embedding_dim
            if spec.type == NUMERIC:
                w = torch.empty(1, dim, device=device)
                xavier_normal_(w, generator)
                self.numeric[spec.name] = nn.Parameter(w)
            elif spec.table_name not in self.tables:
                w = torch.empty(self._table_rows(spec), dim, device=device)
                if emb_init_scheme == "normal":
                    with torch.no_grad():
                        w.normal_(0.0, emb_init_std, generator=generator)
                elif emb_init_scheme == "xavier_normal":
                    xavier_normal_(w, generator)
                else:
                    xavier_uniform_(w, generator)
                self.tables[spec.table_name] = nn.Parameter(w)
            flat = spec.type == SEQUENCE and (
                not sequence_pooling or spec.pooling not in ("mean", "sum"))
            out_dim += dim * spec.max_len if flat else dim
        # width of concat_embeddings over this module's features
        self.out_dim = out_dim

    def _table_rows(self, spec: FeatureSpec) -> int:
        owner = self.feature_map.feature_dict.get(spec.table_name, spec)
        # shared sequence features add a PAD row beyond the base vocab
        rows = max(owner.vocab_size, spec.vocab_size)
        for f in self.feature_map.features:
            if f.table_name == spec.table_name:
                rows = max(rows, f.vocab_size)
        return rows

    def _lookup(self, batch: Dict[str, torch.Tensor], spec: FeatureSpec,
                x: torch.Tensor) -> torch.Tensor:
        rows = batch.get(rows_key_for(self.path, spec.name))
        if rows is None:
            # gather in the table's dtype, cast the (small) result
            rows = F.embedding(x, self.tables[spec.table_name])
        return rows.to(self.dtype)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for spec in self.feats:
            name = spec.name
            if name not in batch:
                continue
            x = batch[name]
            if spec.type == NUMERIC:
                out[name] = (x.to(self.dtype)[:, None]
                             * self.numeric[name].to(self.dtype))
            elif spec.type == CATEGORICAL:
                emb = self._lookup(batch, spec, x)
                if spec.padding_idx is not None:
                    emb = emb * (x != spec.padding_idx).to(emb.dtype)[..., None]
                out[name] = emb
            elif spec.type == SEQUENCE:
                emb = self._lookup(batch, spec, x)                  # (B, L, D)
                pad = spec.padding_idx if spec.padding_idx is not None \
                    else spec.vocab_size - 1
                mask = x != pad
                emb = emb * mask.to(emb.dtype)[..., None]
                if self.sequence_pooling and spec.pooling in ("mean", "sum"):
                    out[name] = masked_pool(emb, mask, spec.pooling)
                elif self.sequence_pooling and spec.pooling == "concat":
                    out[name] = emb.reshape(emb.shape[0], -1)
                else:
                    out[name] = emb
        return out


def concat_embeddings(emb_dict: Dict[str, torch.Tensor],
                      feats: Tuple[FeatureSpec, ...]) -> torch.Tensor:
    """Concatenate per-feature embeddings into one flat (B, sum_dim) tensor
    in schema order; 3-D entries are flattened."""
    parts = []
    for spec in feats:
        if spec.name not in emb_dict:
            continue
        e = emb_dict[spec.name]
        if e.ndim == 3:
            e = e.reshape(e.shape[0], -1)
        parts.append(e)
    return torch.cat(parts, dim=-1)


def stack_embeddings(emb_dict: Dict[str, torch.Tensor],
                     feats: Tuple[FeatureSpec, ...]) -> torch.Tensor:
    """Stack equal-width field embeddings into (B, F, D) in schema order. A
    (B, L, D) entry is pooled first: its padding steps arrive zero-masked,
    so the mean divides by the count of non-zero steps."""
    parts = []
    for spec in feats:
        if spec.name not in emb_dict:
            continue
        parts.append(_field_view(emb_dict[spec.name]))
    return torch.stack(parts, dim=1)


def _field_view(e: torch.Tensor) -> torch.Tensor:
    if e.ndim == 3:
        valid = torch.any(e != 0, dim=-1).to(e.dtype)             # (B, L)
        counts = torch.clamp(torch.sum(valid, dim=1), min=1.0)
        e = torch.sum(e, dim=1) / counts[:, None]
    return e
