"""Serving: trained towers → `RetrievalService`, queried top-k with
seen-item exclusion, a live catalog swap and a save / load round trip
(`examples/serving_retrieval.py`)."""

from __future__ import annotations

import tempfile
from typing import Any, Dict

import numpy as np

from recbox_tpu_torch.data import MatchingLoader
from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.models.matching.two_tower import MF
from recbox_tpu_torch.ops import get_matching_loss
from recbox_tpu_torch.retrieval import RetrievalService
from recbox_tpu_torch.training import Trainer, TrainerConfig


def main(device=None) -> Dict[str, Any]:
    rng = np.random.default_rng(0)
    n_users, n_items, n = 300, 200, 4000
    users = rng.integers(0, n_users, n).astype(np.int32)
    items = ((users % 8) * 25 + rng.integers(0, 25, n)).astype(np.int32)

    fm = FeatureMap(
        "serve", (FeatureSpec("user_id", "categorical", source="user",
                              vocab_size=n_users, embedding_dim=32),
                  FeatureSpec("item_id", "categorical", source="item",
                              vocab_size=n_items, embedding_dim=32)),
        query_index="user_id", corpus_index="item_id", num_items=n_items)

    trainer = Trainer(
        MF(feature_map=fm, embedding_dim=32, device=device),
        lambda o, b: get_matching_loss("PairwiseLogisticLoss")(o),
        TrainerConfig(learning_rate=0.05, epochs=5, monitor="loss",
                      monitor_mode="min"), device=device)
    loader = MatchingLoader(fm, {"user_id": users, "item_id": items},
                            {"item_id": np.arange(n_items, dtype=np.int32)},
                            batch_size=256, num_negs=4, seed=0)
    for _ in range(5):
        for batch in loader:
            trainer.train_step(batch)

    # offline export: encode the corpus once, build the MIPS index
    svc = RetrievalService.from_trainer(
        trainer, {"item_id": np.arange(n_items, dtype=np.int32)},
        method="exact")

    # online queries
    qusers = np.arange(8, dtype=np.int32)
    scores, ids = svc.query({"user_id": qusers}, k=5)
    print("top-5 per user:")
    for u, row in zip(qusers, ids):
        print(f"  user {u} (block {u % 8}): {row.tolist()}")
    in_block = float(np.mean([(ids[r] // 25 == u % 8).mean()
                              for r, u in enumerate(qusers)]))
    print(f"fraction of recommendations inside the user's block: "
          f"{in_block:.2f}")
    assert in_block > 0.8

    # seen-item exclusion: ban each user's current top hits
    seen = [ids[r, :2].tolist() for r in range(len(qusers))]
    _, ids2 = svc.query({"user_id": qusers}, k=5, exclude=seen)
    assert all(not set(seen[r]) & set(ids2[r].tolist())
               for r in range(len(qusers)))
    print("seen-item exclusion OK")

    # catalog swap: serve only the first 50 items (an in-stock subset)
    svc.refresh_items({"item_id": np.arange(50, dtype=np.int32)})
    _, ids3 = svc.query({"user_id": qusers}, k=5)
    assert int(ids3.max()) < 50
    print("catalog swap OK — index rebuilt over", svc.num_items, "items")

    # durable snapshot: save -> load reproduces the serving state without
    # re-encoding the corpus (the model definition is code)
    with tempfile.TemporaryDirectory() as d:
        svc.save(d + "/svc")
        svc_restored = RetrievalService.load(d + "/svc", trainer.model,
                                             device=device)
        _, ids4 = svc_restored.query({"user_id": qusers}, k=5)
        assert np.array_equal(ids3, ids4)
    print("save/load round-trip OK")
    return {"ids": ids, "in_block": in_block, "excluded_ids": ids2,
            "swapped_ids": ids3, "index_method": svc.index.method}


if __name__ == "__main__":
    run_cli(main)
