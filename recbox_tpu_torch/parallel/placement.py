"""Embedding-table placement planning: replicate vs row-shard per table.

Own copy of `recbox_tpu/parallel/placement.py` (:1-213): `TablePlacement`,
`_replicate_saving`, `plan_table_placement`, `predict_step_comm_bytes` and
`apply_placement`, line for line. Only the cost model's two device
constants differ: they are the H100's, not the TPU's.

The choice is per table and a measured trade (RecShard/DreamShard study
exactly this for industry DLRM, see PAPERS.md):

* ROW-SHARD (the default, ``(('data','model'), None)`` over the combined
  grid, `parallel.mesh`): per-step comm is the batch-scaled id/row
  exchange, and each rank holds rows/n_ranks. Right for LARGE tables:
  device memory is the binding constraint.
* REPLICATE (``shard_table=False`` on the spec): every rank holds the
  full table; the gather is local (no exchange latency), and the dense
  gradient all-reduces vocab·dim·4 bytes per step. Right for SMALL, HOT
  tables.

`plan_table_placement` makes the call from a pure-numpy cost model: row
ops cost ~LAT_ROW per touched row and collectives move bytes at
~LINK_BYTES_PER_S. The planner maximizes projected step-time savings
under a per-device memory budget for the replicated set. It is a STATIC
planner (statistics in, placement out) that writes
`FeatureSpec.shard_table`, which `nn.embedding.FeatureEmbedding` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

__all__ = ["TablePlacement", "plan_table_placement", "apply_placement",
           "predict_step_comm_bytes", "LAT_ROW", "LINK_BYTES_PER_S",
           "BYTES_PER_VAL"]

# Cost-model constants, each labeled MEASURED (with the script that
# produced it) or ASSUMED (a vendor figure, not a measurement).
LAT_ROW = 1.63e-9        # MEASURED, NVIDIA H100 80GB HBM3, 700 W,
                         # chip_smoke 5r: index_select + index_add_ of
                         # 851,968 ids in a 2.6M x 128 f32 pack, per id
                         # (1.626e-9 and 1.631e-9 in two calls)
LINK_BYTES_PER_S = 450e9  # ASSUMED: NVLink 4 on an H100 SXM, one direction
                          # (NVIDIA's 900 GB/s total over 18 links, halved).
                          # NOT measured: the card machine has one H100 and
                          # no link to drive; bounds the replicate-vs-shard
                          # trade, not a measured fact.
BYTES_PER_VAL = 4.0      # f32 rows (packed layout pads to 128 lanes anyway)


@dataclasses.dataclass
class TablePlacement:
    name: str
    rows: int
    dim: int
    touches_per_step: float      # expected touched rows per step
    replicate: bool
    hbm_cost_bytes: int          # per-device bytes this choice costs
    step_saving_s: float         # projected step-time saving vs sharding


def _replicate_saving(rows: int, dim: int, touches: float,
                      n_devices: int) -> float:
    """Projected per-step saving of replicating one table vs sharding it.

    Sharded: the table's lookups ride the id/row exchange — their rows
    move across the link and pay the exchange latency. Replicated: the gather
    is local, but the DENSE grad (rows·dim·4 bytes) all-reduces.
    """
    row_bytes = dim * BYTES_PER_VAL
    # sharded cost: exchanged row payload + per-row latency (each touched
    # row crosses a link once in, once back)
    sharded = touches * (2 * row_bytes / LINK_BYTES_PER_S + LAT_ROW)
    # replicated cost: ring all-reduce of the dense grad,
    # 2·(n-1)/n · table_bytes over the link
    table_bytes = rows * row_bytes
    repl = 2.0 * (n_devices - 1) / max(n_devices, 1) \
        * table_bytes / LINK_BYTES_PER_S
    return sharded - repl


def plan_table_placement(
    table_shapes: Mapping[str, tuple],
    touches_per_step: Optional[Mapping[str, float]] = None,
    n_devices: int = 8,
    hbm_budget_bytes: float = 2 * 2 ** 30,
    batch_size: int = 8192,
) -> Dict[str, TablePlacement]:
    """Decide replicate-vs-shard for every table.

    Args:
      table_shapes: {table_name: (rows, dim)}.
      touches_per_step: expected touched rows per step per table (defaults
        to ``batch_size`` — one lookup per example per feature; pass real
        access counts for multi-valued/sequence features or skewed reuse).
      n_devices: mesh size the plan targets.
      hbm_budget_bytes: per-device byte budget the REPLICATED set may
        consume (keep it a small slice of HBM — sharded tables and
        activations own the rest).

    Greedy knapsack: sort candidate tables by saving per replicated byte,
    replicate while the projected saving is positive and the budget holds.
    """
    touches = dict(touches_per_step or {})
    plans: Dict[str, TablePlacement] = {}
    candidates = []
    for name, (rows, dim) in table_shapes.items():
        t = float(touches.get(name, batch_size))
        saving = _replicate_saving(int(rows), int(dim), t, n_devices)
        bytes_full = int(rows * dim * BYTES_PER_VAL)
        plans[name] = TablePlacement(
            name=name, rows=int(rows), dim=int(dim), touches_per_step=t,
            replicate=False,
            hbm_cost_bytes=bytes_full // max(n_devices, 1),
            step_saving_s=0.0)
        if saving > 0:
            candidates.append((saving / max(bytes_full, 1), saving,
                               bytes_full, name))
    budget = float(hbm_budget_bytes)
    for _, saving, bytes_full, name in sorted(candidates, reverse=True):
        extra = bytes_full - plans[name].hbm_cost_bytes  # vs sharded share
        if extra > budget:
            continue
        budget -= extra
        p = plans[name]
        plans[name] = dataclasses.replace(
            p, replicate=True, hbm_cost_bytes=bytes_full,
            step_saving_s=saving)
    return plans


def predict_step_comm_bytes(
    tables: Sequence[tuple],
    batch_size: int,
    n_data: int,
    n_model: int,
    dense_params: int = 0,
) -> Dict[str, float]:
    """Predict the dense-Trainer train step's per-step collective RESULT
    bytes (the quantity `parallel.inspect.collective_stats` counts) for a
    placement, mesh shape, and batch.

    Component model: the collectives the port's step issues
    (`nn.embedding.ShardedLookup`, the trainers' mesh steps; in JAX, the
    GSPMD pattern of the combined-grid sharding, which JAX's tests hold to
    its HLO):

      per SHARDED table (row-sharded over all N = n_data*n_model ranks):
        * id all-gather        touches * 4 bytes      (only when n_data > 1
          — with an unsharded batch every rank already holds all ids)
        * fwd row assembly     touches * dim * 4      (all-reduce of the
          masked local gathers over the table's shard groups)
        * bwd row all-gather   touches * dim * 4      (only when n_data > 1
          — row grads must reach every row shard)
      per REPLICATED table (when n_data > 1):
        * dense grad all-reduce  rows * dim * 4       (one flat all-reduce
          with the dense gradients; result bytes are what count)
      dense params (when n_data > 1): dense_params * 4.

    Result bytes are GLOBAL-batch-shaped and therefore mesh-shape-invariant
    at fixed global batch — the signature of the id/row exchange.

    KNOWN over-prediction in JAX: a SHARDED table with rows < batch is
    assembled vocab-shaped by XLA (min(rows, touches)); the port's
    exchange is always batch-shaped, so there it is exact.

    Args:
      tables: iterable of (rows, dim, sharded: bool[, touches]) — list
        embedding and first-order/linear tables separately (a DeepFM
        categorical feature contributes (V, D, s) and (V, 1, s)).
      batch_size: GLOBAL batch (default `touches` per table).
    Returns {component: bytes} with a 'total' key.
    """
    n = n_data * n_model
    out = {"ids_allgather": 0.0, "fwd_row_assembly": 0.0,
           "bwd_row_allgather": 0.0, "table_grad_allreduce": 0.0,
           "dense_grad_allreduce": 0.0}
    if n > 1:
        for entry in tables:
            rows, dim, sharded = entry[0], entry[1], entry[2]
            touches = entry[3] if len(entry) > 3 else batch_size
            if sharded:
                out["fwd_row_assembly"] += touches * dim * BYTES_PER_VAL
                if n_data > 1:
                    out["ids_allgather"] += touches * 4
                    out["bwd_row_allgather"] += touches * dim * BYTES_PER_VAL
            elif n_data > 1:
                out["table_grad_allreduce"] += rows * dim * BYTES_PER_VAL
        if n_data > 1:
            out["dense_grad_allreduce"] = dense_params * BYTES_PER_VAL
    out["total"] = sum(out.values())
    return out


def apply_placement(feature_map, plans: Mapping[str, TablePlacement]):
    """Write the plan into the schema: returns a NEW FeatureMap whose specs
    carry ``shard_table=False`` for replicated tables (FeatureEmbedding
    reads it when boxing the param's partitioning metadata)."""
    new_specs = []
    for spec in feature_map.features:
        plan = plans.get(spec.table_name)
        if plan is not None:
            new_specs.append(dataclasses.replace(
                spec, shard_table=not plan.replicate))
        else:
            new_specs.append(spec)
    return dataclasses.replace(feature_map, features=tuple(new_specs))
