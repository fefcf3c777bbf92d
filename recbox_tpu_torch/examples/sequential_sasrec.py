"""Next-item recommendation: SASRec under the leave-one-out protocol
(`examples/sequential_sasrec.py`)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from recbox_tpu_torch.data.sequential import leave_one_out_split
from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.quick_start import run_sequential_experiment


def main(device=None) -> Dict[str, float]:
    rng = np.random.default_rng(3)
    n_items = 50
    seqs = {}
    for u in range(400):   # cyclic-walk sessions: next item is predictable
        start = rng.integers(1, n_items + 1)
        seqs[u] = np.array([(start + k - 1) % n_items + 1
                            for k in range(12)])
    train, valid, test = leave_one_out_split(seqs, max_len=10)
    fm = FeatureMap(
        "demo_seq", (FeatureSpec("item_id", "categorical", source="item",
                                 vocab_size=n_items + 1, embedding_dim=32),),
        query_index="user_id", corpus_index="item_id",
        num_items=n_items + 1)
    metrics = run_sequential_experiment(
        {"model": "SASRec", "embedding_dim": 32, "max_seq_len": 10,
         "n_layers": 2, "n_heads": 2, "dropout": 0.1,
         "learning_rate": 5e-3, "epochs": 10, "batch_size": 256,
         "monitor": "NDCG(k=10)", "lr_decay_factor": 1.0,
         "reload_best_on_plateau": False, "patience": 8},
        fm, train, valid, test, device=device)
    print("SASRec leave-one-out:", metrics)
    assert metrics["test_Recall(k=10)"] > 0.7, metrics
    return metrics


if __name__ == "__main__":
    run_cli(main)
