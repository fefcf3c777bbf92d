"""Dataset adapters: KG + sequential fusion and atomic → feature matrix.

Counterpart of `recbox_tpu/data/adapters.py` (`build_kg_sequential` :34,
`atomic_to_feature_matrix` :70), host numpy over the ported
`data/atomic.py`, `data/knowledge.py` and `data/sequential.py`; on the same
atomic files both return JAX's arrays.

* `build_kg_sequential`: leave-one-out next-item splits and the aligned
  knowledge graph (items share the entity id space through ``.link``),
  with the static (n_entities, K) neighbour tables KG-sequential models
  read.
* `atomic_to_feature_matrix`: ``.inter`` joined with the user / item side
  tables into the wide (N, F) matrix the exlib boosters
  (`models/exlib.py`) and `LambdaMART` take: token columns to contiguous
  ints (dropped past ``token_num_threshold`` values), sequence columns
  dropped, floats kept.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from recbox_tpu_torch.data.atomic import AtomicDataset
from recbox_tpu_torch.data.knowledge import (
    KnowledgeGraph, build_neighbor_table,
)
from recbox_tpu_torch.data.sequential import (
    group_user_sequences, leave_one_out_split,
)

__all__ = ["build_kg_sequential", "atomic_to_feature_matrix"]


def build_kg_sequential(
    atomic: AtomicDataset,
    user_field: str = "user_id",
    item_field: str = "item_id",
    time_field: str = "timestamp",
    max_len: int = 50,
    min_hist: int = 1,
    n_neighbors: int = 8,
    seed: int = 0,
):
    """Fused KG + sequential data: LOO splits + aligned KG artifacts.

    Returns (train, valid, test, kg, model_kwargs) where the array dicts
    are in the sliding-window layout (`data/sequential.py`) and
    ``model_kwargs`` carries the static inputs KG-sequential models need:
    ``n_entities`` and ``kg_neighbors`` (the (n_entities, K) entity
    neighbor table; relations table available from the kg itself).
    """
    if atomic.kg is None:
        raise ValueError("build_kg_sequential needs a dataset with a .kg "
                         "file (and usually a .link item↔entity mapping)")
    ts = atomic.inter.get(time_field)
    user_seqs = group_user_sequences(atomic.inter[user_field],
                                     atomic.inter[item_field], ts)
    train, valid, test = leave_one_out_split(user_seqs, max_len=max_len,
                                             min_hist=min_hist)
    kg: KnowledgeGraph = atomic.to_knowledge_graph()
    ent_neigh, rel_neigh = build_neighbor_table(kg, n_neighbors, seed=seed)
    model_kwargs = {
        "n_entities": int(kg.n_entities),
        "kg_neighbors": ent_neigh,
        "kg_relation_neighbors": rel_neigh,
    }
    return train, valid, test, kg, model_kwargs


def atomic_to_feature_matrix(
    atomic: AtomicDataset,
    label_field: str,
    user_field: str = "user_id",
    item_field: str = "item_id",
    token_num_threshold: int = 10000,
    drop_fields: Tuple[str, ...] = (),
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Wide numeric design matrix from atomic tables for tree models.

    Column treatment mirrors `decisiontree_dataset.py:_judge_token_and_
    convert`: user/item ids stay as their contiguous ids; token columns
    become contiguous hash ints unless their cardinality exceeds
    ``token_num_threshold`` (then dropped); sequence-typed columns are
    dropped; float columns pass through. Returns (X float32 (N, F),
    y float32 (N,), feature_names).
    """
    inter = atomic.inter
    if label_field not in inter:
        raise KeyError(f"label field {label_field!r} not in .inter")
    n = len(inter[user_field])
    cols: Dict[str, np.ndarray] = {}

    def add_table(table: Optional[Dict[str, np.ndarray]], key_field: str):
        """Left-join a side table on its id column (rows align by the
        contiguous ids produced by load_atomic_dataset's shared remap)."""
        if table is None:
            return
        keys = np.asarray(table[key_field])
        # build a dense row lookup: id -> row in the side table
        size = int(keys.max()) + 1 if len(keys) else 1
        row_of = np.full(size, -1, np.int64)
        row_of[keys] = np.arange(len(keys))
        idx = np.asarray(inter[key_field])
        rows = row_of[np.clip(idx, 0, size - 1)]
        missing = (rows < 0) | (idx >= size)
        rows = np.where(missing, 0, rows)
        for name, vals in table.items():
            if name == key_field:
                continue
            vals = np.asarray(vals)
            if vals.ndim > 1:       # sequence column → dropped
                continue
            joined = vals[rows]
            # ids absent from the side table get a NULL sentinel, never
            # row 0's values: floats → 0.0, ints → -1 (its own category
            # after the contiguous remap), strings → ''
            if joined.dtype.kind == "f":
                joined = np.where(missing, 0.0, joined)
            elif joined.dtype.kind in "iu":
                joined = np.where(missing, -1, joined)
            elif joined.dtype.kind in "OUS":
                joined = np.where(missing, "", joined)
            cols[name] = joined

    for name, vals in inter.items():
        if name == label_field:
            continue
        vals = np.asarray(vals)
        if vals.ndim > 1:           # sequence column → dropped
            continue
        cols[name] = vals
    add_table(atomic.user, user_field)
    add_table(atomic.item, item_field)

    names, mats = [], []
    for name, vals in cols.items():
        if name in drop_fields:
            continue
        vals = np.asarray(vals)
        if vals.dtype.kind in "iu":
            if name not in (user_field, item_field):
                uniq, contiguous = np.unique(vals, return_inverse=True)
                if len(uniq) > token_num_threshold:
                    continue        # reference: drop over-threshold tokens
                vals = contiguous
            mats.append(vals.astype(np.float32))
        elif vals.dtype.kind == "f":
            mats.append(vals.astype(np.float32))
        elif vals.dtype.kind in "OUS":  # leftover raw tokens → hash ints
            uniq, contiguous = np.unique(vals, return_inverse=True)
            if len(uniq) > token_num_threshold:
                continue
            mats.append(contiguous.astype(np.float32))
        else:
            continue
        names.append(name)
    if not mats:
        raise ValueError("no usable feature columns after conversion")
    X = np.stack(mats, axis=1)
    y = np.asarray(inter[label_field], np.float32)
    return X, y, names
