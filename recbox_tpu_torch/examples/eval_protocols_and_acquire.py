"""Candidate-set evaluation protocols and dataset acquisition, end to end
(`examples/eval_protocols_and_acquire.py`).

* `acquire_dataset`: download by name with cache and checksums, here fed
  a local ``file://`` archive in a temporary directory, so the example
  needs no network;
* full-sort vs 'uni50' vs 'pop50' evaluation of the same MF model:
  sampled-candidate metrics bound the full-sort ones from above, and
  popularity negatives are harder than uniform ones.
"""

from __future__ import annotations

import os
import tempfile
import zipfile
from typing import Dict

import numpy as np

from recbox_tpu_torch.data.acquire import (
    acquire_dataset, register_dataset_url,
)
from recbox_tpu_torch.data.atomic import load_atomic_dataset
from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.quick_start import run_matching_experiment


def make_archive(tmp: str) -> str:
    """A tiny .inter archive standing in for a real dataset mirror."""
    rng = np.random.default_rng(0)
    lines = ["user_id:token\titem_id:token\trating:float\ttimestamp:float\n"]
    for u in range(120):
        for t in range(12):
            item = (u * 3 + t + rng.integers(0, 2)) % 80
            lines.append(f"u{u}\ti{item}\t1.0\t{t}.0\n")
    path = os.path.join(tmp, "demo.zip")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("demo/demo.inter", "".join(lines))
    return path


def _u2i(split) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for u, i in zip(split.user_ids, split.item_ids):
        out.setdefault(int(u), []).append(int(i))
    return out


def main(device=None) -> Dict[str, Dict[str, float]]:
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        register_dataset_url("demo", f"file://{make_archive(tmp)}")
        folder = acquire_dataset("demo", os.path.join(tmp, "data"))
        print("acquired:", folder)
        ds = load_atomic_dataset(os.path.join(tmp, "data", "demo"), "demo")
    inter = ds.to_interactions(time_field="timestamp")
    train, valid, _test = inter.split_ratio((0.8, 0.1, 0.1), order="TO",
                                            group_by_user=True, seed=7)
    train_u2i, valid_u2i = _u2i(train), _u2i(valid)
    fm = FeatureMap(
        "demo", (FeatureSpec("user_id", "categorical", "user",
                             vocab_size=ds.num_users, embedding_dim=16),
                 FeatureSpec("item_id", "categorical", "item",
                             vocab_size=ds.num_items, embedding_dim=16)),
        query_index="user_id", corpus_index="item_id",
        num_items=ds.num_items)
    vu = np.array(sorted(valid_u2i), np.int32)
    base = dict(model="MF", embedding_dim=16, learning_rate=0.05, epochs=8,
                batch_size=256, num_negs=4, monitor="Recall(k=10)",
                patience=10, metrics=["Recall(k=10)", "NDCG(k=10)"],
                # atomic ids start at 1: corpus row 0 is the PAD
                # pseudo-item; mask it in full-sort, never sample it
                exclude_items=[0])
    for proto in ("full", "uni50", "pop50"):
        out = run_matching_experiment(
            {**base, "eval_protocol": proto}, fm,
            {"user_id": train.user_ids.astype(np.int32),
             "item_id": train.item_ids.astype(np.int32)},
            {"item_id": np.arange(ds.num_items, dtype=np.int32)},
            {"user_id": vu}, vu, train_u2i, valid_u2i, device=device)
        print(f"{proto:6s}: " + "  ".join(f"{k}={v:.4f}"
                                          for k, v in out.items()))
        results[proto] = out
    return results


if __name__ == "__main__":
    run_cli(main)
