"""Packed embedding training: one gather and one row update per step.

Counterpart of `recbox_tpu/training/packed.py` `PackedEmbeddingTrainer`.
For each vocabulary, all of its embedding columns across modules plus its
optimizer state share one physical row, and every same-layout vocabulary
stacks into one tall (ΣV, store_w) f32 pack (store_w: the used width
rounded up to 128, the JAX package's layout, so its packs move over
unchanged). Three layouts, as JAX plans them (`packed.py:203-244`):

    AdaGrad, state in the row:  [ emb_D | linear_1 | acc_emb | acc_lin | 0 ]
    AdaGrad, split accumulators: [ values | 0 ] and a separate (ΣV, slots)
        ``accs`` tensor, where the value columns already fill their 128-lane
        pad and one accumulator a slot would cross it (DCNv2 at dim 128);
    lazy Adam (``embedding_optimizer='adam'``): [ values | m | v | 0 ].

A step gathers ``G = pack[ids]`` once, hands each feature's rows to the
model as leaf tensors through the `__rows__` protocol (`nn/embedding.py`),
runs the forward and the backward, steps the dense parameters with Adam,
and updates the pack rows. With the AdaGrad state in the row, the update is
kernel B1 (`ops/packed_delta.py`), which adds the row-wise AdaGrad update
into the pack rows in place, as JAX sends that layout through
`fused_adagrad_delta`. The split layout and lazy Adam are jnp chains in
JAX, outside any Pallas kernel (`packed.py:610-632`, `:654-677`), and are
plain torch here (an ``index_add_`` of the update rows); B1 is never called
on them.

Optimizer semantics are the JAX package's: row-wise AdaGrad; duplicate ids
add their deltas, each from the pre-step accumulator plus its own g²
(per-example AdaGrad, `packed.py:27-32`); lazy Adam updates only the
touched rows, each duplicate from the pre-step m and v, with the bias
correction of the step count (the dense optimizer's count, a device tensor,
so a replayed graph reads it); embedding rows are exempt from the
global-norm clip.

``block_rows`` (JAX `packed.py:245-279`): where the single pack's features
are exactly the batch's categorical 1-D columns, unpadded and unfrozen,
each slot's rows go to the model as one (F, B, D) block in schema order
(`nn.embedding.rows_block_key`); DeepFM's feature-major path reads it
without stacking (`_feature_major_block_logit`), and its gradient comes
back as one tensor that reshapes into the slot's (N, D) gradient, where
the per-feature path concatenates F of them. B1 then updates the pack as
in the per-feature path.

Also ported: exact and direct init, `train_step`, `train_steps_fused` (one
CUDA graph of the step on the card, captured again when the embedding lr
changes, since B1 and the plain updates take it by value),
`train_steps_repeat`, `predict`, the `tables` / `accumulators` views, and
the best-weight cache, `state_dict`, `save` and `load` carrying the packs,
the split accumulators and the embedding lr. The model's state beside its
parameters (BatchNorm statistics) is the dense trainer's `model_state`,
moved by each step's forward, as JAX's packed step threads
``model_state`` (`packed.py:703-725`).

Under a mesh (JAX `packed.py:361-373`, `:915-925`, `:945-955`) every pack
and split accumulator is row-sharded over the combined ('data', 'model')
grid: rank r holds rows ``[r·S, (r+1)·S)`` of a pack, padded. A step
gathers the global batch's value columns through the mesh's exchange (the
ids all-gathered over 'data', each rank's owned rows, an all-reduce over
the world) and hands the model this rank's rows; the row gradients are
all-gathered over 'data', and each rank updates the rows it owns from its
own shard (B1 on the ids it owns, in local row numbers, once a step; the
split and lazy Adam layouts likewise). The owner sees every occurrence of
its ids, so the update is the unsharded one up to B1's order of duplicate
sums. The ``tables`` / ``accumulators`` views and `state_dict` gather the
packs whole (a collective: every rank calls them); `load_state_dict`
shards them again, and the best-weight cache keeps each rank's shard.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from recbox_tpu_torch.features.schema import CATEGORICAL, SEQUENCE
from recbox_tpu_torch.models.base import MatchingModel
from recbox_tpu_torch.nn.embedding import (
    FeatureEmbedding, rows_block_key, rows_key_for,
)
from recbox_tpu_torch.ops.losses import embedding_reg_loss
from recbox_tpu_torch.ops.packed_delta import packed_adagrad_update_
from recbox_tpu_torch.parallel.mesh import (
    export_state, import_state, local_rows, owned_grads, row_bounds,
    sharded_rows, world_size,
)
from recbox_tpu_torch.training.sparse import merge_params, split_sparse_params
from recbox_tpu_torch.training.trainer import Trainer, _copy_into
from recbox_tpu_torch.utils import tracing

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["PackedEmbeddingTrainer"]


class _Slot:
    """One module-table position inside a pack's row layout."""

    __slots__ = ("module_path", "dim", "col_start", "acc_col")

    def __init__(self, module_path: tuple, dim: int, col_start: int,
                 acc_col: int):
        self.module_path = module_path
        self.dim = dim
        self.col_start = col_start
        self.acc_col = acc_col  # column in the pack, or slot index if split


class _Bundle:
    """All tables sharing one vocabulary (tname), packed into pack rows
    [row_offset, row_offset + rows)."""

    __slots__ = ("tname", "row_offset", "rows", "table_keys", "features")

    def __init__(self, tname, row_offset, rows, table_keys, features):
        self.tname = tname
        self.row_offset = row_offset
        self.rows = rows
        self.table_keys = table_keys  # per slot: the table's key
        self.features = features      # feature names routed to this bundle


def _normal_1e4(generator: torch.Generator, shape: Tuple[int, int],
                device: torch.device) -> torch.Tensor:
    """normal(std=1e-4), `FeatureEmbedding`'s default table draw."""
    return 1e-4 * torch.randn(shape, generator=generator, device=device)


class PackedEmbeddingTrainer(Trainer):
    """Trainer with packed-row embeddings and their optimizer state.

    Extra knobs, as in the JAX package: ``embedding_lr`` (default
    max(learning_rate, 5e-2) under AdaGrad, learning_rate under lazy Adam),
    ``adagrad_init`` / ``adagrad_eps`` (also lazy Adam's eps);
    ``embedding_optimizer`` 'adagrad' or 'adam' (lazy Adam with
    ``adam_b1`` / ``adam_b2``); ``block_rows``; ``direct_init`` (None =
    auto) draws the packs directly instead of copying the model's tables;
    ``table_initializer(generator, shape, device)`` overrides that draw
    (default normal std=1e-4). A model built under
    `nn.embedding.abstract_tables()` has no table bytes anywhere: its meta
    tables stay off the trainer's device, and only the direct init (which
    None then picks) can train it, so the packs are the only copy of the
    tables ever made.

    ``delta_kernel`` takes the JAX package's three values, 'auto', 'pallas'
    and 'xla', and every value runs the same update here: kernel B1 on the
    card, its plain version on the CPU, wherever the AdaGrad state is in
    the row. On the TPU 'auto' meant the jnp chain, because XLA fused the
    delta into its scatter and the Pallas kernel only added a (N, 128) f32
    round trip through HBM. On the H100 the plain chain is elementwise
    kernels that write that operand and an ``index_add_`` that reads it
    back, and B1 computes the delta and adds it into the pack rows in one
    pass, so there is no such trade-off to select.
    """

    def __init__(self, model: torch.nn.Module, *args,
                 embedding_lr: Optional[float] = None,
                 adagrad_init: float = 0.0, adagrad_eps: float = 1e-8,
                 direct_init: Optional[bool] = None,
                 table_initializer: Optional[Callable] = None,
                 embedding_optimizer: str = "adagrad",
                 adam_b1: float = 0.9, adam_b2: float = 0.999,
                 delta_kernel: str = "auto", block_rows: bool = False,
                 **kwargs):
        # abstract tables cannot move to a device: hold them out of the
        # move, then put the shapes back for init to plan the packs from
        abstract = []
        for m in model.modules():
            if isinstance(m, FeatureEmbedding):
                meta = [n for n, p in m.tables.items() if p.is_meta]
                abstract += [(m, n, m.tables.pop(n)) for n in meta]
        super().__init__(model, *args, **kwargs)
        for m, name, p in abstract:
            m.tables[name] = p
        self._abstract_tables = bool(abstract)
        if embedding_optimizer not in ("adagrad", "adam"):
            raise NotImplementedError(
                f"embedding_optimizer={embedding_optimizer!r}")
        if delta_kernel not in ("auto", "pallas", "xla"):
            raise NotImplementedError(f"delta_kernel={delta_kernel!r}")
        self.delta_kernel = delta_kernel
        self.block_rows = block_rows
        self.embedding_lr = embedding_lr
        self._emb_lr: Optional[float] = None
        self.adagrad_init = adagrad_init
        self.adagrad_eps = adagrad_eps
        self.direct_init = direct_init
        self.table_initializer = table_initializer
        self.embedding_optimizer = embedding_optimizer
        self.adam_b1 = adam_b1
        self.adam_b2 = adam_b2
        self.packs: Dict[str, torch.Tensor] = {}
        self.accs: Dict[str, torch.Tensor] = {}     # split-layout packs only
        self._best_packs: Dict[str, torch.Tensor] = {}
        self._best_accs: Dict[str, torch.Tensor] = {}
        self._slots: Dict[str, List[_Slot]] = {}
        self._bundles: Dict[str, List[_Bundle]] = {}
        self._acc_in_row: Dict[str, bool] = {}
        self._block_mode: Dict[str, bool] = {}
        self._gather_order: Dict[str, List[Tuple[str, int]]] = {}
        self._pack_store_width: Dict[str, int] = {}
        self._value_width: Dict[str, int] = {}
        self._homes: Dict[str, Tuple[str, str]] = {}
        # under a mesh of more than one rank: {pack: its RowShard}
        self._pack_shards: Dict[str, Any] = {}

    # -- layout construction --------------------------------------------------
    def _plan_layout(self, table_shapes: Dict[str, tuple],
                     sample_batch: Mapping[str, Any]) -> None:
        """Fill the slots, bundles, layouts and block modes from
        {table_key: (rows, dim)}."""
        fm = self.model.feature_map
        by_tname: Dict[str, List[Tuple[str, tuple, int, int]]] = {}
        for tkey in sorted(table_shapes):
            path = tuple(tkey.split("/"))
            tname = path[-1][len("emb_"):]
            rows, dim = table_shapes[tkey]
            by_tname.setdefault(tname, []).append(
                (tkey, path[:-1], int(rows), int(dim)))

        # group bundles by identical (module_path, dim) signature
        groups: Dict[tuple, List[str]] = {}
        for tname, slots in by_tname.items():
            rows0 = slots[0][2]
            if any(s[2] != rows0 for s in slots):
                raise ValueError(f"tables for {tname!r} disagree on rows")
            sig = tuple((s[1], s[3]) for s in slots)
            groups.setdefault(sig, []).append(tname)

        self._slots, self._bundles, self._acc_in_row = {}, {}, {}
        self._pack_store_width, self._value_width = {}, {}
        for sig, tnames in sorted(groups.items(), key=lambda kv: str(kv[0])):
            w_val = sum(d for _, d in sig)
            n_slots = len(sig)
            if self.embedding_optimizer == "adam":
                # [values | m | v]: the per-element state is always in-row
                acc_in_row, state_w = True, 2 * w_val
            else:
                # in-row where the accumulators stay inside the 128-lane pad
                state_w = n_slots
                acc_in_row = -(-(w_val + state_w) // 128) == -(-w_val // 128)
            pack_name = "pack_" + "_".join(
                f"{'/'.join(mp)}x{d}" for mp, d in sig)
            slots, col = [], 0
            for i, (mp, d) in enumerate(sig):
                slots.append(_Slot(mp, d, col,
                                   (w_val + i) if acc_in_row else i))
                col += d
            bundles, row = [], 0
            for tname in sorted(tnames):
                tks = [s[0] for s in by_tname[tname]]
                rows = by_tname[tname][0][2]
                feats = tuple(
                    f.name for f in fm.input_features
                    if f.type in (CATEGORICAL, SEQUENCE)
                    and f.table_name == tname and f.name in sample_batch)
                bundles.append(_Bundle(tname, row, rows, tks, feats))
                row += rows
            self._slots[pack_name] = slots
            self._bundles[pack_name] = bundles
            self._acc_in_row[pack_name] = acc_in_row
            used = w_val + state_w if acc_in_row else w_val
            self._pack_store_width[pack_name] = -(-used // 128) * 128
            self._value_width[pack_name] = w_val
        self._plan_blocks(sample_batch)
        orphans = [b.tname for bl in self._bundles.values() for b in bl
                   if not b.features]
        if orphans:
            raise ValueError(
                "these tables have no feature routed through the __rows__ "
                f"protocol (FeatureEmbedding): {sorted(orphans)}; "
                "PackedEmbeddingTrainer requires all categorical/sequence "
                "features to flow through FeatureEmbedding modules")

    def _plan_blocks(self, sample_batch: Mapping[str, Any]) -> None:
        """Block mode for a pack (JAX `packed.py:245-279`): asked for, the
        only pack, its routed features exactly the batch's categorical
        1-D columns, one slot a module, and none padded or frozen (the
        model's block path reads raw rows; the padding masks and the
        freeze live in the module's per-feature path). The block's F axis
        is the schema's order, the order the module reads it in."""
        fm = self.model.feature_map
        self._block_mode, self._gather_order = {}, {}
        cat_in_batch = [f.name for f in fm.input_features
                        if f.type == CATEGORICAL and f.name in sample_batch]
        for pname, bundles in self._bundles.items():
            routed = [f for b in bundles for f in b.features]
            slots = self._slots[pname]
            specs = [f for f in fm.input_features if f.name in routed]
            eligible = (
                self.block_rows
                and len(self._bundles) == 1
                and sorted(routed) == sorted(cat_in_batch)
                and all(np.ndim(sample_batch[f]) == 1 for f in routed)
                and len({s.module_path for s in slots}) == len(slots)
                and all(f.padding_idx is None and not f.freeze_emb
                        for f in specs))
            self._block_mode[pname] = eligible
            if eligible:
                offs = {f: b.row_offset for b in bundles for f in b.features}
                self._gather_order[pname] = [(f, offs[f])
                                             for f in cat_in_batch]

    def _packed_physical_bytes(self) -> int:
        return sum(sum(b.rows for b in self._bundles[p])
                   * self._pack_store_width[p] * 4 for p in self._bundles)

    def init(self, sample_batch: Mapping[str, Any]) -> None:
        if isinstance(self.model, MatchingModel):
            # MatchingModel.forward rebuilds item sub-batches, so gathered
            # __rows__ keys would never reach the item tower
            raise NotImplementedError(
                "PackedEmbeddingTrainer does not support MatchingModel "
                "towers (item features flow through extract_item_batch, "
                "bypassing the __rows__ protocol); use Trainer")
        _, tables, homes = split_sparse_params(self.model)
        if not tables:
            logger.warning("PackedEmbeddingTrainer found no tables; "
                           "training densely")
            super().init(sample_batch)
            return
        self._homes = homes
        self._plan_layout({k: tuple(v.shape) for k, v in tables.items()},
                          sample_batch)
        use_direct = self.direct_init
        if self._abstract_tables and use_direct is False:
            raise ValueError(
                "the model's tables were built under abstract_tables(), "
                "so only direct_init can draw them; pass direct_init=True "
                "or None")
        if use_direct is None:
            # the exact path holds the model's tables and the packs at once
            use_direct = (self._abstract_tables
                          or self._packed_physical_bytes() * 2 > 8 * 2 ** 30)
        if use_direct:
            scheme = getattr(self.model, "emb_init_scheme", "normal")
            if self.table_initializer is None and scheme != "normal":
                raise ValueError(
                    f"direct_init draws normal(std=1e-4) but the model "
                    f"specifies emb_init_scheme={scheme!r}; pass "
                    "table_initializer= matching the model's scheme (or "
                    "direct_init=False to keep the exact init path)")
            self._init_direct()
        else:
            self._init_exact(tables)
        self.accs = {
            pname: torch.full((sum(b.rows for b in bundles),
                               len(self._slots[pname])), self.adagrad_init,
                              device=self.device)
            for pname, bundles in self._bundles.items()
            if not self._acc_in_row[pname]}
        # the packs own the table state from here on: drop the model's
        # tables, so its parameters are the dense ones alone; Trainer.init
        # then sets up Adam and hands the dropouts their seeded generator
        if self.mesh is not None and world_size() > 1:
            # row-shard every pack over the combined grid: no rank holds
            # a table replica (JAX `packed.py:361-373`)
            self._pack_shards = {k: row_bounds(v.shape[0], self.mesh)
                                 for k, v in self.packs.items()}
            self.packs = {k: local_rows(v, self.mesh)
                          for k, v in self.packs.items()}
            self.accs = {k: local_rows(v, self.mesh)
                         for k, v in self.accs.items()}
        modules = dict(self.model.named_modules())
        for mname, tname in homes.values():
            del modules[mname].tables[tname]
        super().init(sample_batch)
        n_rows = sum(int(p.shape[0]) for p in self.packs.values())
        logger.info("packed embedding training (%s init): %d packs, %s "
                    "table rows, acc-in-row: %s, block rows: %s",
                    "direct" if use_direct else "exact", len(self.packs),
                    f"{n_rows:,}", self._acc_in_row, self._block_mode)

    def _state_in_row(self, pname: str) -> bool:
        """Whether the pack's row holds AdaGrad accumulators (filled with
        ``adagrad_init``); lazy Adam's m and v start at zero."""
        return self.embedding_optimizer == "adagrad" \
            and self._acc_in_row[pname]

    @torch.no_grad()
    def _init_exact(self, tables: Dict[str, torch.Tensor]) -> None:
        """Re-layout the model's own tables (drawn when it was built) into
        packs."""
        self.packs = {}
        for pname, bundles in self._bundles.items():
            n_slots = len(self._slots[pname])
            store_w = self._pack_store_width[pname]
            parts = []
            for b in bundles:
                vals = [tables[tk].detach().float() for tk in b.table_keys]
                used = sum(int(v.shape[1]) for v in vals)
                if self._state_in_row(pname):
                    vals.append(torch.full((b.rows, n_slots),
                                           self.adagrad_init,
                                           device=self.device))
                    used += n_slots
                if used < store_w:
                    vals.append(torch.zeros((b.rows, store_w - used),
                                            device=self.device))
                parts.append(torch.cat(vals, dim=1))
            self.packs[pname] = torch.cat(parts, dim=0)

    @torch.no_grad()
    def _init_direct(self) -> None:
        """Draw the packs with ``table_initializer`` from a generator seeded
        with ``config.seed``, without reading the model's tables."""
        draw = self.table_initializer or _normal_1e4
        gen = torch.Generator(device=self.device).manual_seed(
            self.config.seed)
        self.packs = {}
        for pname, bundles in self._bundles.items():
            slots = self._slots[pname]
            w_val = self._value_width[pname]
            total = sum(b.rows for b in bundles)
            pack = torch.zeros((total, self._pack_store_width[pname]),
                               device=self.device)
            if self._state_in_row(pname):
                pack[:, w_val:w_val + len(slots)] = self.adagrad_init
            for b in bundles:
                for s in slots:
                    pack[b.row_offset:b.row_offset + b.rows,
                         s.col_start:s.col_start + s.dim] = draw(
                             gen, (b.rows, s.dim), self.device)
            self.packs[pname] = pack

    # -- gather and update ----------------------------------------------------
    @property
    def _rows_dtype(self) -> torch.dtype:
        """The model's compute dtype: rows go to the model in it, so a bf16
        model gets bf16 leaves and gives bf16 row gradients back. Pack
        values and optimizer state stay f32."""
        if getattr(self.model, "compute_dtype", None) == "bfloat16":
            return torch.bfloat16
        return torch.float32

    def _gather_rows(self, dbatch: Dict[str, torch.Tensor],
                     requires_grad: bool = True):
        """(rows for the batch, per-pack update context). Each row entry is
        a leaf tensor of its own, so its gradient comes back separately: a
        (B, D) or (B, L, D) entry a feature and slot, or in block mode one
        (F, B, D) entry a slot. The context is (ids, segments or None in
        block mode, G, the split accumulators at ids or None)."""
        rows: Dict[str, torch.Tensor] = {}
        ctx = {}
        rdtype = self._rows_dtype
        for pname, bundles in self._bundles.items():
            slots = self._slots[pname]
            block = self._block_mode.get(pname, False)
            order = self._gather_order[pname] if block else [
                (fname, b.row_offset) for b in bundles for fname in b.features]
            segs, ids = [], []
            for fname, row_offset in order:
                x = dbatch[fname]
                ids.append(x.reshape(-1).to(torch.int32) + row_offset)
                segs.append((fname, x.numel(), tuple(x.shape)))
            if not ids:
                continue
            ids = torch.cat(ids) if len(ids) > 1 else ids[0]
            if self._pack_shards:
                # the exchange: this rank's rows of the value columns; the
                # owners read the rest at the update. ids become the global
                # batch's
                w_val = self._value_width[pname]
                G, ids = sharded_rows(ids, self.packs[pname][:, :w_val],
                                      self._pack_shards[pname])
                v_pre = None
            else:
                G = self.packs[pname].index_select(0, ids)      # (N, W)
                v_pre = None if self._acc_in_row[pname] \
                    else self.accs[pname].index_select(0, ids)  # (N, S)
            if block:
                G3 = G.reshape(len(segs), segs[0][1], G.shape[1])
                for s in slots:
                    rows[rows_block_key(s.module_path)] = G3[
                        :, :, s.col_start:s.col_start + s.dim].to(
                        rdtype, copy=True).requires_grad_(requires_grad)
                ctx[pname] = (ids, None, G, v_pre)
                continue
            off = 0
            for fname, n, shape in segs:
                for s in slots:
                    r = G[off:off + n, s.col_start:s.col_start + s.dim].to(
                        rdtype, copy=True).reshape(shape + (s.dim,))
                    rows[rows_key_for(s.module_path, fname)] = \
                        r.requires_grad_(requires_grad)
                off += n
            ctx[pname] = (ids, segs, G, v_pre)
        return rows, ctx

    def _slot_grads(self, slots: List[_Slot], segs, row_grads
                    ) -> List[torch.Tensor]:
        """Per slot: its (N, d) row gradients in ids order; in block mode
        (``segs`` None) the (F, B, d) block gradient reshaped."""
        out = []
        for s in slots:
            if segs is None:
                out.append(row_grads[rows_block_key(s.module_path)]
                           .reshape(-1, s.dim))
                continue
            parts = [row_grads[rows_key_for(s.module_path, fname)]
                     .reshape(n, s.dim) for fname, n, _ in segs]
            out.append(torch.cat(parts) if len(parts) > 1 else parts[0])
        return out

    def _owned_inputs(self, pname: str, gids: torch.Tensor,
                      grads: List[torch.Tensor]):
        """Under a mesh: (local row numbers of the global batch's ids this
        rank owns, their pre-step pack rows, their split accumulators or
        None, their per-slot gradients), after the row gradients'
        all-gather over 'data'."""
        widths = [int(g.shape[1]) for g in grads]
        lids, g_own = owned_grads(torch.cat(grads, dim=1) if len(grads) > 1
                                  else grads[0], gids,
                                  self._pack_shards[pname])
        out, c0 = [], 0
        for w in widths:
            out.append(g_own[:, c0:c0 + w].contiguous())
            c0 += w
        lids = lids.to(torch.int32)
        G = self.packs[pname].index_select(0, lids)
        v_pre = None if self._acc_in_row[pname] \
            else self.accs[pname].index_select(0, lids)
        return lids, G, v_pre, out

    def _apply_row_updates(self, row_grads: Dict[str, torch.Tensor],
                           ctx, emb_lr: float) -> None:
        for pname, (ids, segs, G, v_pre) in ctx.items():
            slots = self._slots[pname]
            grads = self._slot_grads(slots, segs, row_grads)
            if self._pack_shards:
                ids, G, v_pre, grads = self._owned_inputs(pname, ids, grads)
            w_val = self._value_width[pname]
            if self.embedding_optimizer == "adam":
                parts = self._lazy_adam_parts(slots, grads, G, w_val, emb_lr)
            elif self._acc_in_row[pname]:
                packed_adagrad_update_(
                    self.packs[pname], ids, G, grads, emb_lr,
                    dims=tuple(s.dim for s in slots),
                    acc_cols=tuple(s.acc_col for s in slots),
                    used=w_val + len(slots), eps=self.adagrad_eps)
                continue
            else:
                parts, g2s = self._split_adagrad_parts(slots, grads, v_pre,
                                                       emb_lr)
                self.accs[pname].index_add_(0, ids, torch.stack(g2s, dim=1))
            used = sum(int(p.shape[1]) for p in parts)
            store_w = self._pack_store_width[pname]
            if used < store_w:
                parts.append(torch.zeros((ids.shape[0], store_w - used),
                                         device=G.device))
            self.packs[pname].index_add_(0, ids, torch.cat(parts, dim=1))

    def _split_adagrad_parts(self, slots, grads, v_pre, emb_lr):
        """The split layout's update (JAX's jnp chain, `packed.py:654-677`):
        per slot the delta -lr · g / (sqrt(acc + mean g²) + eps) from the
        pre-step accumulators ``v_pre`` (N, S), and the mean g² each
        accumulator gains."""
        deltas, g2s = [], []
        for si, g in enumerate(grads):
            g = g.float()
            g2 = torch.mean(torch.square(g), dim=-1)              # (N,)
            deltas.append(-emb_lr * g / (torch.sqrt(v_pre[:, si] + g2)
                                         + self.adagrad_eps)[:, None])
            g2s.append(g2)
        return deltas, g2s

    def _lazy_adam_parts(self, slots, grads, G, w_val, emb_lr):
        """Lazy Adam on the touched rows (JAX `packed.py:610-632`): m and v
        mirror the value columns at offsets w_val and 2 w_val; the update
        rows are [delta | m_new − m_pre | v_new − v_pre], so duplicate ids
        each update from the pre-step state. The bias correction reads the
        dense optimizer's step count, which `_dense_step` has advanced to
        this step's number (JAX's ``step``)."""
        b1, b2 = self.adam_b1, self.adam_b2
        t = torch.clamp(self._opt.count, min=1).to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        deltas, m_upds, v_upds = [], [], []
        for s, g in zip(slots, grads):
            g = g.float()
            c0, c1 = s.col_start, s.col_start + s.dim
            m_pre = G[:, w_val + c0:w_val + c1]
            v_pre = G[:, 2 * w_val + c0:2 * w_val + c1]
            m_new = b1 * m_pre + (1.0 - b1) * g
            v_new = b2 * v_pre + (1.0 - b2) * torch.square(g)
            deltas.append(-emb_lr * (m_new / bc1)
                          / (torch.sqrt(v_new / bc2) + self.adagrad_eps))
            m_upds.append(m_new - m_pre)
            v_upds.append(v_new - v_pre)
        return deltas + m_upds + v_upds

    # -- the train step --------------------------------------------------------
    def _resolve_emb_lr(self) -> float:
        if self._emb_lr is None:
            if self.embedding_lr is not None:
                self._emb_lr = self.embedding_lr
            elif self.embedding_optimizer == "adam":
                self._emb_lr = self.config.learning_rate
            else:
                # AdaGrad needs a much larger step than Adam-calibrated
                # configs carry (its accumulator starts near 0); 5e-2 is
                # the DLRM-regime default
                self._emb_lr = max(self.config.learning_rate, 5e-2)
        return self._emb_lr

    def _train_step(self, dbatch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if not self.packs:
            return super()._train_step(dbatch)
        cfg = self.config
        emb_lr = self._resolve_emb_lr()
        with tracing.phase("packed::gather"):
            rows, ctx = self._gather_rows(dbatch)
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
        grads = self._dense_step(objective, [rows[k] for k in keys])
        with tracing.phase("packed::row_update"):
            self._apply_row_updates(dict(zip(keys, grads)), ctx, emb_lr)
        return loss.detach()

    def _graph_token(self):
        """B1 and the plain updates take the embedding lr by value: a
        captured step holds it, and a new lr (plateau, `load`) needs a new
        capture. A kernel reading the lr from a device pointer would change
        B1's interface for a capture that happens at most once an
        evaluation."""
        return self._resolve_emb_lr() if self.packs else None

    def _forward_inputs(self, dbatch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        if not self.packs:
            return dbatch
        rows, _ = self._gather_rows(dbatch, requires_grad=False)
        return {**dbatch, **rows}

    # -- logical views ----------------------------------------------------------
    def _whole_packs(self, sharded: bool = False
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(packs, split accumulators), gathered whole under a mesh (a
        collective: every rank calls it) or, with ``sharded``, DTensors of
        each rank's rows; else the live ones."""
        return (export_state(self.packs, self._pack_shards, sharded),
                export_state(self.accs, self._pack_shards, sharded))

    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        """{table_key: (V, D)} view of the packed state (whole tables
        gathered under a mesh)."""
        out = {}
        packs, _ = self._whole_packs()
        for pname, bundles in self._bundles.items():
            pack = packs[pname]
            for b in bundles:
                for si, s in enumerate(self._slots[pname]):
                    out[b.table_keys[si]] = pack[
                        b.row_offset:b.row_offset + b.rows,
                        s.col_start:s.col_start + s.dim]
        return out

    @property
    def accumulators(self) -> Dict[str, torch.Tensor]:
        """{table_key: (V,)} second-moment view: the AdaGrad accumulator
        (in the row, or the split ``accs``), or the row-mean of the lazy
        Adam v block."""
        out = {}
        packs, accs = self._whole_packs()
        for pname, bundles in self._bundles.items():
            pack = packs[pname]
            w_val = self._value_width[pname]
            for b in bundles:
                rows = slice(b.row_offset, b.row_offset + b.rows)
                for si, s in enumerate(self._slots[pname]):
                    if self.embedding_optimizer == "adam":
                        c0 = 2 * w_val + s.col_start
                        out[b.table_keys[si]] = torch.mean(
                            pack[rows, c0:c0 + s.dim], dim=-1)
                    elif self._acc_in_row[pname]:
                        out[b.table_keys[si]] = pack[rows, s.acc_col]
                    else:
                        out[b.table_keys[si]] = accs[pname][rows, si]
        return out

    def full_params(self) -> Dict[str, torch.Tensor]:
        """A state_dict of the whole model, tables read from the packs: a
        fresh model of the same configuration loads it."""
        if not self.packs:
            return dict(self.params)
        return merge_params(self.params, self.tables, self._homes)

    def _set_learning_rate(self, lr: float) -> None:
        """The dense lr, and the embedding lr by the same factor."""
        old = self.learning_rate
        super()._set_learning_rate(lr)
        if self._emb_lr is not None and old > 0:
            self._emb_lr = max(self._emb_lr * (lr / old), self.config.min_lr)

    # -- best weights and checkpoints -------------------------------------------
    def _capture_best(self) -> None:
        """The dense parameters, the packs and the split accumulators,
        cloned on their device: the updates write them in place."""
        super()._capture_best()
        self._best_packs = {k: v.clone() for k, v in self.packs.items()}
        self._best_accs = {k: v.clone() for k, v in self.accs.items()}

    @torch.no_grad()
    def _restore_best(self) -> None:
        super()._restore_best()
        for k, v in self._best_packs.items():
            self.packs[k].copy_(v)
        for k, v in self._best_accs.items():
            self.accs[k].copy_(v)

    def state_dict(self, sharded: bool = False) -> Dict[str, Any]:
        """The dense state, the packs, the split accumulators and the
        embedding lr (-1.0 while not yet resolved): the plateau decays it,
        and a resume at the configured value would undo that."""
        state = super().state_dict(sharded)
        packs, accs = self._whole_packs(sharded)
        state["packs"] = dict(packs)
        state["accs"] = dict(accs)
        state["emb_lr"] = float(self._emb_lr if self._emb_lr is not None
                                else -1.0)
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        for name, live in (("packs", self.packs), ("accs", self.accs)):
            saved = state.get(name, {})
            if set(saved) != set(live):
                raise ValueError(f"checkpoint {name} {sorted(saved)} do not "
                                 f"match the trainer's {sorted(live)}")
            saved = import_state(saved, self._pack_shards, self.device)
            for k, t in live.items():
                _copy_into(t, saved[k], k)
        if float(state.get("emb_lr", -1.0)) > 0:
            self._emb_lr = float(state["emb_lr"])
        super().load_state_dict(state)
