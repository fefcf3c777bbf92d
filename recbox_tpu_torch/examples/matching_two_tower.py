"""Retrieval end to end: MF-BPR two-tower, negative sampling, full-corpus
top-k evaluation with beyond-accuracy metrics
(`examples/matching_two_tower.py`)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from recbox_tpu_torch.data import MatchingLoader
from recbox_tpu_torch.evaluation import RetrievalEvaluator
from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.models.matching.two_tower import MF
from recbox_tpu_torch.ops import get_matching_loss
from recbox_tpu_torch.training import Trainer, TrainerConfig


def main(device=None) -> Dict[str, float]:
    rng = np.random.default_rng(0)
    n_users, n_items, n = 300, 200, 3600
    users = rng.integers(0, n_users, n).astype(np.int32)
    # 8 latent blocks: users click items in their block. Kept sparse (~12
    # clicks a user over 25 block items) so held-out items are usually
    # unseen in train; seen ones are masked out of the top-k at eval
    items = ((users % 8) * 25 + rng.integers(0, 25, n)).astype(np.int32)
    split = int(0.9 * n)
    fm = FeatureMap(
        "demo_match", (
            FeatureSpec("user_id", "categorical", source="user",
                        vocab_size=n_users, embedding_dim=32),
            FeatureSpec("item_id", "categorical", source="item",
                        vocab_size=n_items, embedding_dim=32)),
        query_index="user_id", corpus_index="item_id", num_items=n_items)

    train_u2i, valid_u2i = {}, {}
    for u, i in zip(users[:split], items[:split]):
        train_u2i.setdefault(int(u), []).append(int(i))
    for u, i in zip(users[split:], items[split:]):
        valid_u2i.setdefault(int(u), []).append(int(i))
    uu = np.unique(users[split:])

    evaluator = RetrievalEvaluator(
        {"user_id": uu.astype(np.int32)},
        {"item_id": np.arange(n_items, dtype=np.int32)}, uu,
        train_u2i, valid_u2i,
        metrics=["Recall(k=20)", "NDCG(k=10)", "HitRate(k=20)"],
        beyond_accuracy_metrics=["ItemCoverage", "GiniIndex"],
        beyond_topk=20)
    trainer = Trainer(
        MF(feature_map=fm, embedding_dim=32, device=device),
        lambda out, b: get_matching_loss("PairwiseLogisticLoss")(out),
        TrainerConfig(learning_rate=0.05, epochs=20, patience=6,
                      monitor="Recall(k=20)", grad_clip_norm=10.0),
        eval_fn=evaluator, device=device)
    loader = MatchingLoader(fm, {"user_id": users[:split],
                                 "item_id": items[:split]},
                            {"item_id": np.arange(n_items, dtype=np.int32)},
                            batch_size=512, num_negs=10, seed=1)
    metrics = trainer.fit(loader)
    print("MF-BPR retrieval:", metrics)
    # each user has ~25 in-block items but only their held-out clicks
    # count as relevant; block recovery shows as HitRate
    assert metrics["HitRate(k=20)"] > 0.7, metrics
    return metrics


if __name__ == "__main__":
    run_cli(main)
