"""One call from a dataset name to metrics (`examples/one_call_run_experiment.py`).

`run_experiment(model, dataset)` chains acquisition (download by name with
cache and sha256; here a ``file://`` archive in a temporary directory, so
the example needs no network), the atomic load, filtering and remapping,
the split and the stage's training and evaluation.
"""

from __future__ import annotations

import os
import tempfile
import zipfile
from typing import Dict

import numpy as np

from recbox_tpu_torch.data.acquire import register_dataset_url
from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.quick_start import run_experiment


def make_archive(tmp: str) -> str:
    """ml-100k-format archive with planted block structure: each user
    rates one item cluster 5.0 and a few random others low."""
    rng = np.random.default_rng(0)
    lines = ["user_id:token\titem_id:token\trating:float\ttimestamp:float\n"]
    for u in range(80):
        c0 = (u % 4) * 12
        t = 0
        for i in rng.permutation(np.arange(c0, c0 + 12)):
            lines.append(f"u{u}\ti{i}\t5.0\t{t}.0\n")
            t += 1
        for i in rng.choice([x for x in range(48) if not c0 <= x < c0 + 12],
                            size=4, replace=False):
            lines.append(f"u{u}\ti{i}\t{rng.integers(1, 3)}.0\t{t}.0\n")
            t += 1
    path = os.path.join(tmp, "demo100k.zip")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("demo100k/demo100k.inter", "".join(lines))
    return path


def main(device=None) -> Dict[str, Dict[str, float]]:
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        register_dataset_url("demo100k", f"file://{make_archive(tmp)}")
        data_dir = os.path.join(tmp, "data")

        # matching: BPR (MF + pairwise logistic loss), ratio split,
        # full-sort
        out = run_experiment(
            "BPR", "demo100k", data_dir=data_dir, embedding_dim=16,
            learning_rate=0.05, epochs=6, batch_size=128, num_negs=4,
            min_rating=4.0, monitor="Recall(k=10)", patience=10,
            metrics=["Recall(k=10)", "NDCG(k=10)"], seed=1, device=device)
        print("BPR:", {k: round(v, 4) for k, v in out.items()})
        assert out["Recall(k=10)"] > 0.5, out
        results["BPR"] = out

        # traditional: closed-form ItemKNN through the same call
        out = run_experiment("ItemKNN", "demo100k", data_dir=data_dir,
                             min_rating=4.0, metrics=["Recall(k=10)"],
                             device=device)
        print("ItemKNN:", {k: round(v, 4) for k, v in out.items()})
        results["ItemKNN"] = out

        # ranking: FM on the binarized labels (5.0 vs low noise ratings)
        out = run_experiment(
            "FM", "demo100k", data_dir=data_dir, embedding_dim=16,
            binarize_threshold=4.0, learning_rate=0.05, epochs=5,
            batch_size=128, monitor="AUC", metrics=["AUC", "logloss"],
            seed=1, device=device)
        print("FM:", {k: round(v, 4) for k, v in out.items()})
        results["FM"] = out
    return results


if __name__ == "__main__":
    run_cli(main)
