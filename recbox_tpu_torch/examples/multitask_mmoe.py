"""Multi-task CTR: MMOE with per-task heads (click + conversion)
(`examples/multitask_mmoe.py`)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.quick_start import run_ranking_experiment


def main(device=None) -> Dict[str, float]:
    rng = np.random.default_rng(0)
    n = 12_000
    a = rng.integers(1, 50, n).astype(np.int32)
    b = rng.integers(1, 30, n).astype(np.int32)
    click = ((a % 3 == 0) | (b % 5 == 0)).astype(np.float32)
    conv = ((a % 3 == 0) & (b % 2 == 0)).astype(np.float32)
    arrays = {"a": a, "b": b, "click": click, "conversion": conv}
    fm = FeatureMap("demo_mtl", (
        FeatureSpec("a", "categorical", vocab_size=50, embedding_dim=16),
        FeatureSpec("b", "categorical", vocab_size=30, embedding_dim=16)),
        labels=("click", "conversion"))
    split = int(0.85 * n)
    metrics = run_ranking_experiment(
        {"model": "MMOE", "embedding_dim": 16, "n_experts": 4,
         "expert_units": [32], "tower_units": [16],
         "learning_rate": 3e-3, "epochs": 8, "patience": 6,
         "monitor": "AUC", "batch_size": 512, "lr_decay_factor": 1.0,
         "reload_best_on_plateau": False},
        fm, {k: v[:split] for k, v in arrays.items()},
        {k: v[split:] for k, v in arrays.items()}, device=device)
    print("MMOE multitask:", metrics)
    assert (metrics["click_AUC"] > 0.8
            and metrics["conversion_AUC"] > 0.8), metrics
    return metrics


if __name__ == "__main__":
    run_cli(main)
