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
keys are the JAX package's. Its block variant: ``rows_block_key(path)``
carries one (F, B, D) tensor of the rows of every categorical feature in
the batch, F in schema order; the module reads feature f as its f-th
slice, and the backward gives the trainer one (F, B, D) gradient
(`PackedEmbeddingTrainer(block_rows=True)`).

Pretrained tables (`embedding.py:95-118`): ``FeatureSpec.pretrain_path``
names a local .npy, or .npz (its 'embeddings' array, else its only one);
its rows fill the table's leading rows over the usual draw, and a matrix
of the wrong width or with more rows than the table raises ValueError, as
in JAX. ``freeze_emb`` (on the feature or on its table's owner) detaches
the looked-up rows, so no gradient reaches the table: the dense trainer's
optimizer then sees zeros there, as JAX's does after ``stop_gradient``.
Placement (JAX `embedding.py:212-219`): a table is row-sharded under a
mesh when its owner's ``FeatureSpec.shard_table`` says so, else when the
module's ``shard_tables`` (default True) does; `parallel.mesh.shard_params`
then leaves this rank's shard in ``tables[<table>]`` and its `RowShard` in
``table_shards[<table>]``, and the lookup runs the mesh's exchange
(`parallel.mesh.sharded_embedding`). A replicated table is an ordinary
parameter whose gradient the trainer all-reduces.

Abstract tables: a model built inside ``abstract_tables()`` has its tables
as shapes on the meta device, with no bytes and no draw (the counterpart of
the abstract init that JAX's ``direct_init`` runs, `packed.py:316-329`).
Only `PackedEmbeddingTrainer`'s direct init trains such a model: it draws
the tables straight into its packs, so no dense table is ever made.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import (
    CATEGORICAL, NUMERIC, SEQUENCE, FeatureMap, FeatureSpec,
)
from recbox_tpu_torch.nn.core import (
    normal_table, xavier_normal_, xavier_uniform_,
)

__all__ = ["FeatureEmbedding", "concat_embeddings", "stack_embeddings",
           "masked_pool", "emb_init", "abstract_tables", "ROWS_PREFIX",
           "rows_key_for", "BLOCK_PREFIX", "rows_block_key"]

_ABSTRACT_TABLES = contextvars.ContextVar("abstract_tables", default=False)


@contextlib.contextmanager
def abstract_tables() -> Iterator[None]:
    """Inside, every `FeatureEmbedding` built makes its tables as shapes on
    the meta device (no bytes, no draw); see the module docstring."""
    token = _ABSTRACT_TABLES.set(True)
    try:
        yield
    finally:
        _ABSTRACT_TABLES.reset(token)


def emb_init(std: float = 1e-4) -> Callable:
    """JAX's ``emb_init(std)``: an initializer ``init(shape, generator,
    device=None)`` that draws a normal(0, std) table from the explicit
    generator (`nn/core.py` `normal_table`; Philox, not JAX's threefry)."""
    def init(shape, generator: Optional[torch.Generator],
             device: Optional[torch.device] = None) -> nn.Parameter:
        return normal_table(shape, std, generator, device)
    return init

ROWS_PREFIX = "__rows__"
BLOCK_PREFIX = "__rows_block__"


def rows_key_for(module_path: Tuple[str, ...], feature_name: str) -> str:
    """Batch key of the pre-gathered rows of ``feature_name`` for the
    FeatureEmbedding at ``module_path``."""
    return ROWS_PREFIX + "/".join(module_path) + ":" + feature_name


def rows_block_key(module_path: Tuple[str, ...]) -> str:
    """Batch key of the (F, B, D) block of pre-gathered rows of every
    categorical feature of the FeatureEmbedding at ``module_path``."""
    return BLOCK_PREFIX + "/".join(module_path)


def _load_pretrained_matrix(path: str) -> np.ndarray:
    """A (vocab, dim) matrix from .npy, or .npz (key 'embeddings'
    preferred, else the single array)."""
    data = np.load(path, allow_pickle=False)
    if isinstance(data, np.ndarray):
        return data
    keys = list(data.keys())
    key = "embeddings" if "embeddings" in keys else keys[0]
    if "embeddings" not in keys and len(keys) > 1:
        raise ValueError(
            f"pretrained npz {path!r} has multiple arrays {keys}; store "
            "the matrix under the key 'embeddings'")
    return data[key]


@torch.no_grad()
def _pretrained_init_(table: torch.Tensor, path: str) -> None:
    """Overwrite the leading rows of the drawn ``table`` (rows, dim) with
    the pretrained matrix at ``path``; rows beyond the file (PAD, a shared
    vocabulary's extension) keep the draw."""
    rows, dim = table.shape
    arr = _load_pretrained_matrix(path)
    if arr.ndim != 2 or arr.shape[1] != dim:
        raise ValueError(
            f"pretrained matrix {path!r} has shape {arr.shape}; "
            f"expected (<= {rows}, {dim})")
    if arr.shape[0] > rows:
        raise ValueError(
            f"pretrained matrix {path!r} has {arr.shape[0]} rows but "
            f"the table only has {rows}")
    table[:arr.shape[0]] = torch.as_tensor(
        np.asarray(arr), dtype=table.dtype).to(table.device)


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
      shard_tables: row-shard the tables under a mesh where the owner's
        spec leaves ``shard_table`` unset (JAX's module default).
    """

    def __init__(self, feature_map: FeatureMap, source: Optional[str] = None,
                 embedding_dim: Optional[int] = None,
                 sequence_pooling: bool = True,
                 emb_init_scheme: str = "normal", emb_init_std: float = 1e-4,
                 dtype: torch.dtype = torch.float32,
                 name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None,
                 shard_tables: bool = True):
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
        self.shard_tables = shard_tables
        # {table: parallel.mesh.RowShard} once shard_params shards it
        self.table_shards: Dict[str, object] = {}
        self.tables = nn.ParameterDict()
        self.numeric = nn.ParameterDict()
        out_dim = 0
        for spec in self.feats:
            dim = embedding_dim or spec.embedding_dim
            if spec.type == NUMERIC:
                w = torch.empty(1, dim, device=device)
                xavier_normal_(w, generator)
                self.numeric[spec.name] = nn.Parameter(w)
            elif spec.table_name not in self.tables \
                    and _ABSTRACT_TABLES.get():
                self.tables[spec.table_name] = nn.Parameter(torch.empty(
                    self._table_rows(spec), dim, device="meta"))
            elif spec.table_name not in self.tables:
                w = torch.empty(self._table_rows(spec), dim, device=device)
                if emb_init_scheme == "normal":
                    with torch.no_grad():
                        w.normal_(0.0, emb_init_std, generator=generator)
                elif emb_init_scheme == "xavier_normal":
                    xavier_normal_(w, generator)
                else:
                    xavier_uniform_(w, generator)
                pretrain = self._pretrain_path(spec)
                if pretrain:
                    _pretrained_init_(w, pretrain)
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

    def _owner(self, spec: FeatureSpec) -> FeatureSpec:
        return self.feature_map.feature_dict.get(spec.table_name, spec)

    def _pretrain_path(self, spec: FeatureSpec) -> Optional[str]:
        """The table's pretrained file: its owner's, else the first one a
        feature sharing the table names."""
        path = self._owner(spec).pretrain_path
        for f in self.feature_map.features:
            if f.table_name == spec.table_name:
                path = path or f.pretrain_path
        return path

    def table_sharded(self, tname: str) -> bool:
        """Whether table ``tname`` row-shards under a mesh: its owner's
        ``shard_table``, else the module's ``shard_tables``."""
        first = next((f for f in self.feats if f.table_name == tname), None)
        owner = self.feature_map.feature_dict.get(tname, first)
        flag = None if owner is None else owner.shard_table
        return self.shard_tables if flag is None else bool(flag)

    def _frozen(self, spec: FeatureSpec) -> bool:
        return self._owner(spec).freeze_emb or spec.freeze_emb

    def _lookup(self, batch: Dict[str, torch.Tensor], spec: FeatureSpec,
                x: torch.Tensor) -> torch.Tensor:
        rows = batch.get(rows_key_for(self.path, spec.name))
        if rows is None:
            # gather in the table's dtype, cast the (small) result
            shard = self.table_shards.get(spec.table_name)
            if shard is not None:
                from recbox_tpu_torch.parallel.mesh import sharded_embedding
                rows = sharded_embedding(x, self.tables[spec.table_name],
                                         shard)
            else:
                rows = F.embedding(x, self.tables[spec.table_name])
        return rows.to(self.dtype)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        # the block protocol: feature f of the categorical features in the
        # batch, in schema order, is the block's f-th slice
        block = batch.get(rows_block_key(self.path))
        if block is not None:
            block = block.to(self.dtype)
        block_i = 0
        for spec in self.feats:
            name = spec.name
            if name not in batch:
                continue
            x = batch[name]
            if spec.type == NUMERIC:
                out[name] = (x.to(self.dtype)[:, None]
                             * self.numeric[name].to(self.dtype))
            elif spec.type == CATEGORICAL:
                if block is not None:
                    emb = block[block_i]
                    block_i += 1
                else:
                    emb = self._lookup(batch, spec, x)
                if self._frozen(spec):
                    emb = emb.detach()
                if spec.padding_idx is not None:
                    emb = emb * (x != spec.padding_idx).to(emb.dtype)[..., None]
                out[name] = emb
            elif spec.type == SEQUENCE:
                emb = self._lookup(batch, spec, x)                  # (B, L, D)
                if self._frozen(spec):
                    emb = emb.detach()
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
