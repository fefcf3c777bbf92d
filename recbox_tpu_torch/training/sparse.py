"""Split a model's embedding tables from its dense parameters, and merge
them back.

Counterpart of `recbox_tpu/training/sparse.py` `split_sparse_params` and
`_merge_params` (:61-100). A table is a parameter in the ``tables`` of a
`FeatureEmbedding`; its key is the JAX package's param path
(``embedding/emb_c0``: the module's flax name, then ``emb_<table>``), so
the packed trainer's layout and views carry the JAX keys.
`SparseEmbeddingTrainer` is not ported yet (`ROADMAP.md`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from recbox_tpu_torch.nn.embedding import FeatureEmbedding

__all__ = ["split_sparse_params", "merge_params"]


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
