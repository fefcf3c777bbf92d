"""Sparse embedding training: row-wise AdaGrad on the rows a batch touches.

Counterpart of `recbox_tpu/training/sparse.py`: `split_sparse_params`,
`merge_params` (:61-100) and `SparseEmbeddingTrainer` (:102-425). A table is
a parameter in the ``tables`` of a `FeatureEmbedding`; its key is the JAX
package's param path (``item_embedding/emb_item_id``: the module's flax
name, then ``emb_<table>``).

`SparseEmbeddingTrainer` trains the other parameters with the dense
optimizer and each table with row-wise AdaGrad, one accumulator a row. A
step gathers each routed feature's rows outside autograd and hands them to
the model through the `__rows__` protocol (`nn/embedding.py`) as leaf
tensors, so the backward gives (n, D) row gradients and no table-sized
one. Then, table by table, in JAX's order (`sparse.py:240-248`): the mean
g² of every occurrence is added into the accumulator first, then each
occurrence is scaled by ``emb_lr / (sqrt(v[id]) + eps)`` from the summed
accumulator, then added into the table (``index_add_``; on the card with
atomics, in no fixed order). A repeated id thus takes its scale from all
of the batch's occurrences, not from those before it.

The tables stay the model's own parameters and are updated in place, so
evaluation, serving (`RetrievalService.from_trainer`) and a captured step
read them with no merge; `_restore_best` and `load` write in place too.
The embedding lr is a device tensor (the plateau decays it by the dense
lr's factor), so `train_steps_fused`'s CUDA graph needs no new capture.

Routing. As in JAX, each categorical or sequence feature of the batch goes
to its module's table. For a `MatchingModel` (which JAX's trainer does not
run: its item tower reads the ``item::`` columns, where no rows are
handed), the port routes an item-side module's features from those
columns (``item::<feature>`` rows under ``item::<rows key>``, which
`extract_item_batch` hands to the item tower) and the others from the top
level: the rows the towers read, each occurrence once.

Under a mesh the sharded tables are row-sharded over the combined grid
(`parallel.mesh.shard_params`, as JAX's `Trainer.init` shards them), with
their accumulators: a step gathers this rank's rows through the mesh's
exchange, all-gathers the row gradients over 'data', and each rank applies
the row-wise AdaGrad to the rows it owns in its local shard. The owner sees
every occurrence of its ids, so the update is the unsharded one. The
``tables`` then hold each rank's shard; `state_dict` gathers them whole
(every rank calls it) and `load_state_dict` shards them again. A
replicated table (``shard_table=False``) is whole on every rank: its ids
and row gradients are all-gathered over 'data', and every replica applies
every occurrence of the global batch, in one order, so the replicas stay
equal and the update is the global batch's, as JAX's.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import CATEGORICAL, SEQUENCE
from recbox_tpu_torch.models.base import ITEM_PREFIX, MatchingModel
from recbox_tpu_torch.nn.core import set_dropout_generator
from recbox_tpu_torch.nn.embedding import FeatureEmbedding, rows_key_for
from recbox_tpu_torch.ops.losses import embedding_reg_loss
from recbox_tpu_torch.parallel.mesh import (
    DATA_AXIS, all_gather, export_state, import_state, owned_grads,
    shard_params, sharded_rows, world_size,
)
from recbox_tpu_torch.training.trainer import (
    Trainer, _copy_into, _make_optimizer,
)
from recbox_tpu_torch.utils import tracing

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["SparseEmbeddingTrainer", "split_sparse_params", "merge_params"]


def split_sparse_params(model: nn.Module
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor],
                                   Dict[str, Tuple[str, str]]]:
    """(dense, tables, homes) of ``model``.

    dense: {parameter name: tensor} of every parameter outside a table;
    tables: {table key: (rows, dim) tensor}; homes: {table key: (name of the
    owning FeatureEmbedding in the model, table name)}."""
    tables: Dict[str, torch.Tensor] = {}
    homes: Dict[str, Tuple[str, str]] = {}
    table_ids = set()
    for mname, m in model.named_modules():
        if not isinstance(m, FeatureEmbedding):
            continue
        for tname, p in m.tables.items():
            key = "/".join(m.path + ("emb_" + tname,))
            if key in tables:
                raise ValueError(f"two FeatureEmbedding modules give the "
                                 f"table key {key!r}; name them apart")
            tables[key] = p
            homes[key] = (mname, tname)
            table_ids.add(id(p))
    dense = {n: p for n, p in model.named_parameters()
             if id(p) not in table_ids}
    return dense, tables, homes


def merge_params(dense: Dict[str, torch.Tensor],
                 tables: Dict[str, torch.Tensor],
                 homes: Dict[str, Tuple[str, str]]) -> Dict[str, torch.Tensor]:
    """A state_dict of the whole model: the dense entries plus every table
    under its parameter name (``<module>.tables.<table>``)."""
    out = dict(dense)
    for key, t in tables.items():
        mname, tname = homes[key]
        out[f"{mname}.tables.{tname}" if mname else f"tables.{tname}"] = t
    return out


def _index_add(t: torch.Tensor, ids: torch.Tensor, x: torch.Tensor) -> None:
    t.index_add_(0, ids, x)


def _ordered_add(t: torch.Tensor, ids: torch.Tensor, x: torch.Tensor
                 ) -> None:
    """``t.index_add_(0, ids, x)`` with each row's duplicates summed in
    one fixed order, so replicas that apply the same occurrences stay equal
    bit for bit: on the card the sorted accumulation of ``index_put_``
    (``index_add_`` there adds by atomics, in no fixed order); on the CPU
    ``index_add_``, which runs through ``ids`` in order."""
    if t.is_cuda:
        t.index_put_((ids,), x, accumulate=True)
    else:
        t.index_add_(0, ids, x)


class SparseEmbeddingTrainer(Trainer):
    """Trainer with row-wise AdaGrad on the embedding tables.

    Extra knobs, as in JAX: ``embedding_lr`` (default the config's
    learning rate), ``adagrad_init`` (the accumulators' start) and
    ``adagrad_eps``. A model without `FeatureEmbedding` tables trains
    densely, with a warning."""

    def __init__(self, *args, embedding_lr: Optional[float] = None,
                 adagrad_init: float = 0.0, adagrad_eps: float = 1e-8,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.embedding_lr = embedding_lr
        self.adagrad_init = adagrad_init
        self.adagrad_eps = adagrad_eps
        self.tables: Dict[str, torch.Tensor] = {}
        self.accumulators: Dict[str, torch.Tensor] = {}
        # (batch key of the ids, table key, batch key of the rows)
        self._routes: List[Tuple[str, str, str]] = []
        self._emb_lr: Optional[torch.Tensor] = None
        self._best_tables: Dict[str, torch.Tensor] = {}
        self._best_accums: Dict[str, torch.Tensor] = {}
        # under a mesh of more than one rank: {table key: its RowShard}
        self._shards: Dict[str, Any] = {}
        # under a mesh of more than one rank: the replicated tables keep
        # their replicas equal
        self._replicas = False
        self._step_gids: Dict[str, torch.Tensor] = {}

    def init(self, sample_batch: Mapping[str, Any]) -> None:
        if self.mesh is not None:
            from recbox_tpu_torch.parallel.mesh import param_partition_specs
            self.param_specs = param_partition_specs(self.model)
            shard_params(self.model, self.mesh, self.param_specs)
        dense, tables, homes = split_sparse_params(self.model)
        if not tables:
            logger.warning("SparseEmbeddingTrainer found no tables; "
                           "training densely")
            super().init(sample_batch)
            return
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(self.config.seed)
        set_dropout_generator(self.model, self.dropout_generator)
        self.params = dense
        self._opt = _make_optimizer(self.config, list(dense.values()))
        self.tables = tables
        if self.mesh is not None and world_size() > 1:
            modules = dict(self.model.named_modules())
            self._shards = {
                k: modules[mname].table_shards[tname]
                for k, (mname, tname) in homes.items()
                if tname in modules[mname].table_shards}
            self._replicas = len(self._shards) < len(tables)
        self.accumulators = {
            k: torch.full((t.shape[0],), float(self.adagrad_init),
                          dtype=torch.float32, device=self.device)
            for k, t in tables.items()}
        emb_lr = self.embedding_lr if self.embedding_lr is not None \
            else self.config.learning_rate
        self._emb_lr = torch.tensor(float(emb_lr), dtype=torch.float32,
                                    device=self.device)
        modules = dict(self.model.named_modules())
        matching = isinstance(self.model, MatchingModel)
        fm = self.model.feature_map
        self._routes = []
        for tkey, (mname, tname) in homes.items():
            module = modules[mname]
            from_items = matching and module.source == "item"
            for f in fm.input_features:
                if f.type not in (CATEGORICAL, SEQUENCE) \
                        or f.table_name != tname:
                    continue
                rkey = rows_key_for(module.path, f.name)
                if from_items:
                    f_key, rkey = ITEM_PREFIX + f.name, ITEM_PREFIX + rkey
                else:
                    f_key = f.name
                if f_key in sample_batch:
                    self._routes.append((f_key, tkey, rkey))
        n_rows = sum(int(t.shape[0]) for t in tables.values())
        logger.info("sparse embedding training: %d tables, %s rows",
                    len(tables), f"{n_rows:,}")

    # -- the step ---------------------------------------------------------------
    def _train_step(self, dbatch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if not self.tables:
            return super()._train_step(dbatch)
        cfg = self.config
        with tracing.phase("sparse::gather"):
            rows = {rkey: self._rows(dbatch[fkey], tkey, rkey)
                    .requires_grad_(True)
                    for fkey, tkey, rkey in self._routes}
        self.model.train()
        with tracing.phase("trainer::forward"):
            loss = self.loss_fn(self._step_forward({**dbatch, **rows}),
                                dbatch)
        row_reg = None
        if cfg.embedding_regularizer:
            # (1/2)·p2 on the touched rows, once per batch occurrence
            row_reg = cfg.embedding_regularizer * 0.5 * sum(
                torch.sum(torch.square(r.float())) for r in rows.values())
        if cfg.net_regularizer:
            loss = loss + cfg.net_regularizer * embedding_reg_loss(
                self.params, prefix="", device=self.device)
        objective, loss = self._mesh_loss(loss, rows=row_reg)
        keys = list(rows)
        grads = dict(zip(keys, self._dense_step(objective,
                                                [rows[k] for k in keys])))
        with tracing.phase("sparse::row_update"):
            self._row_updates(dbatch, grads)
        return loss.detach()

    @torch.no_grad()
    def _rows(self, ids: torch.Tensor, tkey: str, rkey: str
              ) -> torch.Tensor:
        """The rows of ``ids``: a plain gather, or under a mesh the
        exchange (the global batch's ids kept for the update)."""
        shard = self._shards.get(tkey)
        if shard is None:
            return F.embedding(ids, self.tables[tkey])
        rows, self._step_gids[rkey] = sharded_rows(ids, self.tables[tkey],
                                                   shard)
        return rows

    @torch.no_grad()
    def _row_updates(self, dbatch: Dict[str, torch.Tensor],
                     grads: Dict[str, torch.Tensor]) -> None:
        """Row-wise AdaGrad, table by table: every occurrence's mean g²
        into the accumulator, then each occurrence scaled from the summed
        accumulator and added into the table."""
        by_table: Dict[str, List[Tuple[str, str]]] = {}
        for fkey, tkey, rkey in self._routes:
            by_table.setdefault(tkey, []).append((fkey, rkey))
        for tkey, routes in by_table.items():
            table, v = self.tables[tkey], self.accumulators[tkey]
            d = table.shape[1]
            g = torch.cat([grads[r].reshape(-1, d) for _, r in routes]) \
                .float()
            add = _index_add
            if tkey in self._shards:
                # every occurrence of the rows this rank owns, in its
                # shard's row numbers
                gids = torch.cat([self._step_gids[r] for _, r in routes])
                ids, g = owned_grads(g, gids, self._shards[tkey])
            else:
                ids = torch.cat([dbatch[f].reshape(-1) for f, _ in routes]) \
                    .to(torch.int64)
                if self._replicas:
                    # a replicated table: every replica applies every
                    # occurrence of the global batch, in one order
                    ids = all_gather(ids, self.mesh, DATA_AXIS)
                    g = all_gather(g.contiguous(), self.mesh, DATA_AXIS)
                    add = _ordered_add
            add(v, ids, torch.mean(torch.square(g), dim=-1))
            scale = self._emb_lr / (torch.sqrt(v[ids]) + self.adagrad_eps)
            add(table, ids, (-scale)[:, None] * g)

    # -- lr plateau ---------------------------------------------------------------
    @property
    def emb_lr(self) -> Optional[float]:
        return None if self._emb_lr is None else float(self._emb_lr)

    def _set_learning_rate(self, lr: float) -> None:
        """The dense lr, and the embedding lr by the same factor (at least
        ``min_lr``)."""
        old = self.learning_rate
        super()._set_learning_rate(lr)
        if self._emb_lr is not None and old > 0:
            self._emb_lr.fill_(max(float(self._emb_lr) * (lr / old),
                                   self.config.min_lr))

    # -- best weights and checkpoints ---------------------------------------------
    def _capture_best(self) -> None:
        super()._capture_best()
        self._best_tables = {k: t.detach().clone()
                             for k, t in self.tables.items()}
        self._best_accums = {k: v.clone()
                             for k, v in self.accumulators.items()}

    @torch.no_grad()
    def _restore_best(self) -> None:
        super()._restore_best()
        for k, v in self._best_tables.items():
            self.tables[k].copy_(v)
        for k, v in self._best_accums.items():
            self.accumulators[k].copy_(v)

    def state_dict(self, sharded: bool = False) -> Dict[str, Any]:
        """The dense state, the tables, their accumulators and the embedding
        lr (-1.0 before `init`); under a mesh whole tables, or DTensors of
        each rank's rows with ``sharded``."""
        state = super().state_dict(sharded)
        state["tables"] = export_state(
            {k: t.detach() for k, t in self.tables.items()}, self._shards,
            sharded)
        state["accumulators"] = export_state(self.accumulators, self._shards,
                                             sharded)
        state["emb_lr"] = self.emb_lr if self._emb_lr is not None else -1.0
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        for name, live in (("tables", self.tables),
                           ("accumulators", self.accumulators)):
            if set(state[name]) != set(live):
                raise ValueError(f"checkpoint {name} {sorted(state[name])} "
                                 f"do not match the trainer's {sorted(live)}")
            saved = import_state(state[name], self._shards, self.device)
            for k, t in live.items():
                _copy_into(t, saved[k], k)
        if float(state.get("emb_lr", -1.0)) > 0 and self._emb_lr is not None:
            self._emb_lr.fill_(float(state["emb_lr"]))
        super().load_state_dict(state)
