"""CTR ranking end to end: encode, then a one-call experiment on the
packed trainer (`examples/ranking_deepfm.py`)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureEncoder
from recbox_tpu_torch.quick_start import run_ranking_experiment


def main(device=None) -> Dict[str, float]:
    rng = np.random.default_rng(0)
    n = 20_000
    raw = {
        "user_id": rng.integers(0, 200, n).astype(str),
        "item_id": rng.integers(0, 100, n).astype(str),
        "price": rng.lognormal(0.0, 1.0, n),
    }
    logit = (raw["user_id"].astype(int) % 5 == raw["item_id"].astype(int) % 5
             ).astype(float) * 3.0 - 1.5 + 0.2 * np.log1p(raw["price"])
    raw["click"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(
        np.float32)

    enc = FeatureEncoder(
        feature_cols=[
            {"name": "user_id", "type": "categorical"},
            {"name": "item_id", "type": "categorical"},
            {"name": "price", "type": "numeric",
             "normalizer": "StandardScaler"},
        ],
        label_cols=["click"], dataset_id="demo_ctr")
    fm = enc.fit(raw)
    arrays = enc.transform(raw)
    split = int(0.8 * n)
    train = {k: v[:split] for k, v in arrays.items()}
    valid = {k: v[split:] for k, v in arrays.items()}

    metrics = run_ranking_experiment(
        {"model": "DeepFM", "embedding_dim": 16, "hidden_units": [64, 32],
         "learning_rate": 3e-3, "epochs": 15, "patience": 6,
         "lr_decay_factor": 1.0, "reload_best_on_plateau": False,
         "monitor": "AUC", "batch_size": 1024, "trainer": "packed"},
        fm, train, valid, device=device)
    print("DeepFM (packed trainer):", metrics)
    assert metrics["AUC"] > 0.6
    return metrics


if __name__ == "__main__":
    run_cli(main)
