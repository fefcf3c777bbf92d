"""Reranking: PRM listwise refinement over ranked candidate lists
(`examples/rerank_prm.py`)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.quick_start import run_rerank_experiment


def main(device=None) -> Dict[str, float]:
    rng = np.random.default_rng(0)
    B, N, D = 512, 10, 8
    feats = rng.normal(size=(B, N, D)).astype(np.float32)
    # clicks driven by a feature interaction the pointwise ranker missed
    labels = ((feats[..., 0] + 0.5 * feats[..., 1]) > 0).astype(np.float32)
    mask = np.ones((B, N), bool)
    lists = {"item_feats": feats, "labels": labels, "mask": mask}
    valid = {k: a[:128] for k, a in lists.items()}
    train = {k: a[128:] for k, a in lists.items()}
    metrics = run_rerank_experiment(
        {"model": "PRM", "d_model": 32, "n_layers": 1, "n_heads": 2,
         "max_list_len": N, "learning_rate": 1e-2, "epochs": 10,
         "batch_size": 64, "monitor": "MAP@5", "lr_decay_factor": 1.0,
         "reload_best_on_plateau": False}, train, valid, device=device)
    print("PRM rerank:", metrics)
    assert metrics["MAP@5"] > 0.8, metrics
    return metrics


if __name__ == "__main__":
    run_cli(main)
