"""Production-scale embeddings on one card: PackedEmbeddingTrainer.

``direct_init`` draws the packed [values | optimizer-state] rows straight
on the device, and a model built under ``abstract_tables()`` has its tables
as shapes only, so no dense table (and no dense optimizer state) is ever
made: the capacity is the packed bytes alone (26 × 1M × 64 tables with
their AdaGrad state are a 26M × 128 f32 pack, 13.3 GB; `chip_smoke.py`
phase 5s trains that on the H100). This example runs the same code path at
toy scale (`examples/big_vocab_packed.py`).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.models.ranking.ctr import DeepFM
from recbox_tpu_torch.nn import abstract_tables
from recbox_tpu_torch.ops import binary_crossentropy
from recbox_tpu_torch.training import TrainerConfig
from recbox_tpu_torch.training.packed import PackedEmbeddingTrainer

NUM_CAT, VOCAB, DIM, BATCH, STEPS = 6, 10_000, 16, 512, 8


def build(device=None) -> Tuple[PackedEmbeddingTrainer, Dict[str, np.ndarray]]:
    """(trainer, the one batch it trains on), at the script's sizes."""
    feats = tuple(FeatureSpec(f"c{i}", "categorical", vocab_size=VOCAB,
                              embedding_dim=DIM) for i in range(NUM_CAT))
    fm = FeatureMap("demo_big", feats, labels=("click",))
    rng = np.random.default_rng(0)
    batch = {f"c{i}": rng.integers(0, VOCAB, BATCH).astype(np.int32)
             for i in range(NUM_CAT)}
    batch["click"] = (batch["c0"] % 2).astype(np.float32)
    with abstract_tables():      # tables are born packed, never dense
        model = DeepFM(fm, embedding_dim=DIM, hidden_units=(64, 32),
                       device=device)
    trainer = PackedEmbeddingTrainer(
        model, lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(learning_rate=1e-3, monitor="AUC"),
        direct_init=True, device=device)
    return trainer, batch


def main(device=None) -> Dict[str, Any]:
    trainer, batch = build(device)
    losses = [float(trainer.train_step(dict(batch))) for _ in range(STEPS)]
    pack = next(iter(trainer.packs.values()))
    mib = pack.numel() * pack.element_size() / 2**20
    print(f"pack shape {tuple(pack.shape)} ({mib:.1f} MiB incl. optimizer "
          "state)")
    print(f"losses: {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0]
    return {"pack_shape": tuple(pack.shape), "pack_mib": mib,
            "losses": losses}


if __name__ == "__main__":
    run_cli(main)
