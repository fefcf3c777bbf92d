"""Packed embedding training: one gather and one row update per step.

Counterpart of `recbox_tpu/training/packed.py` `PackedEmbeddingTrainer`.
For each vocabulary, all of its embedding columns across modules plus one
AdaGrad accumulator per module share one physical row:

    [ emb_D columns | linear_1 column | acc_emb | acc_linear | 0 pad ]

and every same-layout vocabulary stacks into one tall (ΣV, store_w) f32
pack (store_w: the used width rounded up to 128, the JAX package's layout,
so its packs move over unchanged). A step gathers ``G = pack[ids]`` once,
hands each feature's rows to the model as leaf tensors through the
`__rows__` protocol (`nn/embedding.py`), runs the forward and the backward,
steps the dense parameters with Adam, and passes the row gradients to
kernel B1 (`ops/packed_delta.py`), which adds the row-wise AdaGrad update
into the pack rows in place.

Optimizer semantics are the JAX package's: row-wise AdaGrad; duplicate ids
add their deltas, each from the pre-step accumulator plus its own g²
(per-example AdaGrad, `packed.py:27-32`); embedding rows are exempt from the
global-norm clip.

Ported: the layout planner without block mode, exact and direct init, the
per-feature gather, the AdaGrad acc-in-row update, `train_step`,
`train_steps_fused` (one CUDA graph of the step on the card, captured again
when the embedding lr changes, since B1 takes it by value),
`train_steps_repeat`, `predict`, the `tables` / `accumulators` views, and
the best-weight cache, `state_dict`, `save` and `load` carrying the packs
and the embedding lr. The model's state beside its parameters (BatchNorm
statistics) is the dense trainer's `model_state`, moved by each step's
forward, as JAX's packed step threads ``model_state`` (`packed.py:703-725`).
A model with one embedding module (DCNv2: one value slot a pack row) and
one with two (DeepFM, xDeepFM: values and first-order weights) plan their
packs alike, as JAX's planner does. Not ported yet, each raising NotImplementedError
(`ROADMAP.md`): lazy Adam (``embedding_optimizer='adam'``), the
split-accumulator layout (value columns already a multiple of 128) and
``block_rows``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.profiler import record_function

from recbox_tpu_torch.features.schema import CATEGORICAL, SEQUENCE
from recbox_tpu_torch.models.base import MatchingModel
from recbox_tpu_torch.nn.embedding import rows_key_for
from recbox_tpu_torch.ops.losses import embedding_reg_loss
from recbox_tpu_torch.ops.packed_delta import packed_adagrad_update_
from recbox_tpu_torch.training.sparse import merge_params, split_sparse_params
from recbox_tpu_torch.training.trainer import Trainer, _copy_into

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["PackedEmbeddingTrainer"]

_PACKED_ITEM = "is not ported yet (ROADMAP.md, Queue A: packed training)"


class _Slot:
    """One module-table position inside a pack's row layout."""

    __slots__ = ("module_path", "dim", "col_start", "acc_col")

    def __init__(self, module_path: tuple, dim: int, col_start: int,
                 acc_col: int):
        self.module_path = module_path
        self.dim = dim
        self.col_start = col_start
        self.acc_col = acc_col


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
    """Trainer with packed-row embeddings and in-row AdaGrad state.

    Extra knobs, as in the JAX package: ``embedding_lr`` (default
    max(learning_rate, 5e-2)), ``adagrad_init`` / ``adagrad_eps``;
    ``direct_init`` (None = auto) draws the packs directly instead of
    copying the model's tables; ``table_initializer(generator, shape,
    device)`` overrides that draw (default normal std=1e-4).

    ``delta_kernel`` takes the JAX package's three values, 'auto', 'pallas'
    and 'xla', and every value runs the same update here: kernel B1 on the
    card, its plain version on the CPU. On the TPU 'auto' meant the jnp
    chain, because XLA fused the delta into its scatter and the Pallas
    kernel only added a (N, 128) f32 round trip through HBM. On the H100
    the plain chain is elementwise kernels that write that operand and an
    ``index_add_`` that reads it back, and B1 computes the delta and adds it
    into the pack rows in one pass, so there is no such trade-off to
    select.
    """

    def __init__(self, *args, embedding_lr: Optional[float] = None,
                 adagrad_init: float = 0.0, adagrad_eps: float = 1e-8,
                 direct_init: Optional[bool] = None,
                 table_initializer: Optional[Callable] = None,
                 embedding_optimizer: str = "adagrad",
                 delta_kernel: str = "auto", block_rows: bool = False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if embedding_optimizer == "adam":
            raise NotImplementedError(f"lazy Adam on the packs {_PACKED_ITEM}")
        if embedding_optimizer != "adagrad":
            raise NotImplementedError(
                f"embedding_optimizer={embedding_optimizer!r}")
        if delta_kernel not in ("auto", "pallas", "xla"):
            raise NotImplementedError(f"delta_kernel={delta_kernel!r}")
        if block_rows:
            raise NotImplementedError(f"block_rows {_PACKED_ITEM}")
        self.delta_kernel = delta_kernel
        self.embedding_lr = embedding_lr
        self._emb_lr: Optional[float] = None
        self.adagrad_init = adagrad_init
        self.adagrad_eps = adagrad_eps
        self.direct_init = direct_init
        self.table_initializer = table_initializer
        self.embedding_optimizer = embedding_optimizer
        self.packs: Dict[str, torch.Tensor] = {}
        self._best_packs: Dict[str, torch.Tensor] = {}
        self._slots: Dict[str, List[_Slot]] = {}
        self._bundles: Dict[str, List[_Bundle]] = {}
        self._pack_store_width: Dict[str, int] = {}
        self._value_width: Dict[str, int] = {}
        self._homes: Dict[str, Tuple[str, str]] = {}

    # -- layout construction --------------------------------------------------
    def _plan_layout(self, table_shapes: Dict[str, tuple],
                     sample_batch: Mapping[str, Any]) -> None:
        """Fill _slots/_bundles from {table_key: (rows, dim)}."""
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

        self._slots, self._bundles = {}, {}
        self._pack_store_width, self._value_width = {}, {}
        for sig, tnames in sorted(groups.items(), key=lambda kv: str(kv[0])):
            w_val = sum(d for _, d in sig)
            n_slots = len(sig)
            if -(-(w_val + n_slots) // 128) != -(-w_val // 128):
                raise NotImplementedError(
                    f"the split-accumulator layout (value columns {w_val}, "
                    f"accumulators past the 128-lane pad) {_PACKED_ITEM}")
            pack_name = "pack_" + "_".join(
                f"{'/'.join(mp)}x{d}" for mp, d in sig)
            slots, col = [], 0
            for i, (mp, d) in enumerate(sig):
                slots.append(_Slot(mp, d, col, w_val + i))
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
            self._pack_store_width[pack_name] = -(-(w_val + n_slots)
                                                  // 128) * 128
            self._value_width[pack_name] = w_val
        orphans = [b.tname for bl in self._bundles.values() for b in bl
                   if not b.features]
        if orphans:
            raise ValueError(
                "these tables have no feature routed through the __rows__ "
                f"protocol (FeatureEmbedding): {sorted(orphans)}; "
                "PackedEmbeddingTrainer requires all categorical/sequence "
                "features to flow through FeatureEmbedding modules")

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
        if use_direct is None:
            # the exact path holds the model's tables and the packs at once
            use_direct = self._packed_physical_bytes() * 2 > 8 * 2 ** 30
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
        # the packs own the table state from here on: drop the model's
        # tables, so its parameters are the dense ones alone; Trainer.init
        # then sets up Adam and hands the dropouts their seeded generator
        modules = dict(self.model.named_modules())
        for mname, tname in homes.values():
            del modules[mname].tables[tname]
        super().init(sample_batch)
        n_rows = sum(int(p.shape[0]) for p in self.packs.values())
        logger.info("packed embedding training (%s init): %d packs, %s "
                    "table rows", "direct" if use_direct else "exact",
                    len(self.packs), f"{n_rows:,}")

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
                vals.append(torch.full((b.rows, n_slots), self.adagrad_init,
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
        a leaf tensor of its own, so its gradient comes back separately."""
        rows: Dict[str, torch.Tensor] = {}
        ctx = {}
        rdtype = self._rows_dtype
        for pname, bundles in self._bundles.items():
            slots = self._slots[pname]
            segs, ids = [], []
            for b in bundles:
                for fname in b.features:
                    x = dbatch[fname]
                    ids.append(x.reshape(-1).to(torch.int32) + b.row_offset)
                    segs.append((fname, x.numel(), tuple(x.shape)))
            if not ids:
                continue
            ids = torch.cat(ids) if len(ids) > 1 else ids[0]
            G = self.packs[pname].index_select(0, ids)          # (N, W)
            off = 0
            for fname, n, shape in segs:
                for s in slots:
                    r = G[off:off + n, s.col_start:s.col_start + s.dim].to(
                        rdtype, copy=True).reshape(shape + (s.dim,))
                    rows[rows_key_for(s.module_path, fname)] = \
                        r.requires_grad_(requires_grad)
                off += n
            ctx[pname] = (ids, segs, G)
        return rows, ctx

    def _slot_grads(self, slots: List[_Slot], segs, row_grads
                    ) -> List[torch.Tensor]:
        """Per slot: its (N, d) row gradients concatenated in ids order."""
        out = []
        for s in slots:
            parts = [row_grads[rows_key_for(s.module_path, fname)]
                     .reshape(n, s.dim) for fname, n, _ in segs]
            out.append(torch.cat(parts) if len(parts) > 1 else parts[0])
        return out

    def _apply_row_updates(self, row_grads: Dict[str, torch.Tensor],
                           ctx, emb_lr: float) -> None:
        for pname, (ids, segs, G) in ctx.items():
            slots = self._slots[pname]
            packed_adagrad_update_(
                self.packs[pname], ids, G,
                self._slot_grads(slots, segs, row_grads), emb_lr,
                dims=tuple(s.dim for s in slots),
                acc_cols=tuple(s.acc_col for s in slots),
                used=self._value_width[pname] + len(slots),
                eps=self.adagrad_eps)

    # -- the train step --------------------------------------------------------
    def _resolve_emb_lr(self) -> float:
        if self._emb_lr is None:
            # AdaGrad needs a much larger step than Adam-calibrated configs
            # carry (its accumulator starts near 0); 5e-2 is the DLRM-regime
            # default
            self._emb_lr = (self.embedding_lr if self.embedding_lr is not None
                            else max(self.config.learning_rate, 5e-2))
        return self._emb_lr

    def _train_step(self, dbatch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if not self.packs:
            return super()._train_step(dbatch)
        cfg = self.config
        emb_lr = self._resolve_emb_lr()
        with record_function("packed::gather"):
            rows, ctx = self._gather_rows(dbatch)
        self.model.train()
        with record_function("trainer::forward"):
            loss = self.loss_fn(self._step_forward({**dbatch, **rows}),
                                dbatch)
        if cfg.embedding_regularizer:
            # (1/2)·p2 on the touched rows, once per batch occurrence
            loss = loss + cfg.embedding_regularizer * 0.5 * sum(
                torch.sum(torch.square(r.float())) for r in rows.values())
        if cfg.net_regularizer:
            loss = loss + cfg.net_regularizer * embedding_reg_loss(
                self.params, prefix="", device=self.device)
        keys = list(rows)
        grads = self._dense_step(loss, [rows[k] for k in keys])
        with record_function("packed::row_update"):
            self._apply_row_updates(dict(zip(keys, grads)), ctx, emb_lr)
        return loss.detach()

    def _graph_token(self):
        """B1 takes the embedding lr by value: a captured step holds it, and
        a new lr (plateau, `load`) needs a new capture. A kernel reading the
        lr from a device pointer would change B1's interface for a capture
        that happens at most once an evaluation."""
        return self._resolve_emb_lr() if self.packs else None

    def _forward_inputs(self, dbatch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        if not self.packs:
            return dbatch
        rows, _ = self._gather_rows(dbatch, requires_grad=False)
        return {**dbatch, **rows}

    # -- logical views ----------------------------------------------------------
    @property
    def tables(self) -> Dict[str, torch.Tensor]:
        """{table_key: (V, D)} view of the packed state."""
        out = {}
        for pname, bundles in self._bundles.items():
            pack = self.packs[pname]
            for b in bundles:
                for si, s in enumerate(self._slots[pname]):
                    out[b.table_keys[si]] = pack[
                        b.row_offset:b.row_offset + b.rows,
                        s.col_start:s.col_start + s.dim]
        return out

    @property
    def accumulators(self) -> Dict[str, torch.Tensor]:
        """{table_key: (V,)} view of the AdaGrad accumulators."""
        out = {}
        for pname, bundles in self._bundles.items():
            pack = self.packs[pname]
            for b in bundles:
                for si, s in enumerate(self._slots[pname]):
                    out[b.table_keys[si]] = pack[
                        b.row_offset:b.row_offset + b.rows, s.acc_col]
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
        """The dense parameters and the packs (values and accumulators),
        cloned on their device: B1 updates the packs in place."""
        super()._capture_best()
        self._best_packs = {k: v.clone() for k, v in self.packs.items()}

    @torch.no_grad()
    def _restore_best(self) -> None:
        super()._restore_best()
        for k, v in self._best_packs.items():
            self.packs[k].copy_(v)

    def state_dict(self) -> Dict[str, Any]:
        """The dense state, the packs and the embedding lr (-1.0 while not
        yet resolved): the plateau decays it, and a resume at the
        configured value would undo that."""
        state = super().state_dict()
        state["packs"] = dict(self.packs)
        state["emb_lr"] = float(self._emb_lr if self._emb_lr is not None
                                else -1.0)
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        if set(state["packs"]) != set(self.packs):
            raise ValueError(f"checkpoint packs {sorted(state['packs'])} do "
                             f"not match the trainer's {sorted(self.packs)}")
        for k, pack in self.packs.items():
            _copy_into(pack, state["packs"][k], k)
        if float(state.get("emb_lr", -1.0)) > 0:
            self._emb_lr = float(state["emb_lr"])
        super().load_state_dict(state)
