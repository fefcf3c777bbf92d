"""Hyperparameter search: TPE over a DeepFM space (`examples/hyper_tuning.py`)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from recbox_tpu_torch.config.hyper_tuning import HyperTuning
from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.quick_start import run_ranking_experiment


def main(device=None) -> Dict[str, Any]:
    rng = np.random.default_rng(0)
    n = 6000
    a = rng.integers(1, 40, n).astype(np.int32)
    b = rng.integers(1, 30, n).astype(np.int32)
    y = ((a % 2) == (b % 2)).astype(np.float32)
    arrays = {"a": a, "b": b, "click": y}
    fm = FeatureMap("demo_tune", (
        FeatureSpec("a", "categorical", vocab_size=40, embedding_dim=8),
        FeatureSpec("b", "categorical", vocab_size=30, embedding_dim=8)),
        labels=("click",))
    split = int(0.8 * n)
    train = {k: v[:split] for k, v in arrays.items()}
    valid = {k: v[split:] for k, v in arrays.items()}

    def objective(params):
        cfg = {"model": "DeepFM", "embedding_dim": 8,
               "hidden_units": [params["width"]],
               "learning_rate": params["lr"], "epochs": 4, "patience": 6,
               "monitor": "AUC", "batch_size": 256, "lr_decay_factor": 1.0,
               "reload_best_on_plateau": False}
        return run_ranking_experiment(cfg, fm, train, valid, device=device)

    tuner = HyperTuning(objective, space={
        "lr": ("loguniform", 1e-3, 5e-2),
        "width": ("choice", [16, 32]),
    }, algo="bayes", max_evals=6, metric_key="AUC", mode="max", seed=0)
    tuner.run()
    print("best:", tuner.best_params, tuner.best_score)
    assert tuner.best_score > 0.9, tuner.best_score
    return {"best_params": tuner.best_params,
            "best_score": tuner.best_score}


if __name__ == "__main__":
    run_cli(main)
