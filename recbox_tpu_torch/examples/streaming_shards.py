"""Disk-resident training data: save npz shards, stream them with
prefetch into `fit` (`examples/streaming_shards.py`)."""

from __future__ import annotations

import tempfile
from typing import Dict

import numpy as np

from recbox_tpu_torch.data import ShardLoader, save_shards
from recbox_tpu_torch.evaluation import CTREvaluator
from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.models.ranking.ctr import DeepFM
from recbox_tpu_torch.ops import binary_crossentropy
from recbox_tpu_torch.training import Trainer, TrainerConfig


def main(device=None) -> Dict[str, float]:
    rng = np.random.default_rng(0)
    n = 50_000
    a = rng.integers(1, 100, n).astype(np.int32)
    y = ((a % 2) == 0).astype(np.float32)
    fm = FeatureMap("demo_shards", (
        FeatureSpec("a", "categorical", vocab_size=100, embedding_dim=8),),
        labels=("click",))
    with tempfile.TemporaryDirectory(prefix="recbox_shards_") as shard_dir:
        save_shards(shard_dir, {"a": a, "click": y}, rows_per_shard=8192)
        print(f"wrote shards to {shard_dir}")
        trainer = Trainer(
            DeepFM(fm, embedding_dim=8, hidden_units=(16,), device=device),
            lambda o, b: binary_crossentropy(o, b["click"]),
            TrainerConfig(learning_rate=1e-2, epochs=3, patience=4,
                          monitor="AUC", lr_decay_factor=1.0,
                          reload_best_on_plateau=False),
            eval_fn=CTREvaluator({"a": a[:2000], "click": y[:2000]},
                                 label="click", metrics=["AUC"]),
            device=device)
        metrics = trainer.fit(ShardLoader(shard_dir, batch_size=1024,
                                          drop_last=True, seed=1))
    print("streamed fit:", metrics)
    assert metrics["AUC"] > 0.95, metrics
    return metrics


if __name__ == "__main__":
    run_cli(main)
