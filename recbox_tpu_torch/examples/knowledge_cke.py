"""Knowledge-enhanced retrieval: CKE with alternating CF and KG-loss
phases (`examples/knowledge_cke.py`)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from recbox_tpu_torch.data.knowledge import KnowledgeGraph
from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.quick_start import run_kg_experiment


def main(device=None) -> Dict[str, float]:
    rng = np.random.default_rng(0)
    n_users, n_items, n_blocks = 120, 80, 8
    ub = rng.integers(0, n_blocks, n_users)
    ib = np.arange(n_items) % n_blocks
    users, items = [], []
    for u in range(n_users):
        block = np.flatnonzero(ib == ub[u])
        chosen = rng.choice(block, size=7, replace=False)
        users += [u] * 7
        items += list(chosen)
    users, items = np.asarray(users, np.int32), np.asarray(items, np.int32)
    train_u2i, valid_u2i = {}, {}
    for u in range(n_users):
        mine = items[users == u]
        train_u2i[u] = [int(i) for i in mine[:-1]]
        valid_u2i[u] = [int(mine[-1])]
    tr_users = np.concatenate([[u] * len(v) for u, v in train_u2i.items()])
    tr_items = np.concatenate(list(train_u2i.values()))

    # KG: each item has-category its block entity
    kg = KnowledgeGraph(heads=np.arange(n_items),
                        relations=np.full(n_items, 1),
                        tails=n_items + ib, n_entities=n_items + n_blocks,
                        n_relations=2, n_items=n_items)
    fm = FeatureMap(
        "demo_kg", (FeatureSpec("user_id", "categorical", source="user",
                                vocab_size=n_users, embedding_dim=16),
                    FeatureSpec("item_id", "categorical", source="item",
                                vocab_size=n_items, embedding_dim=16)),
        query_index="user_id", corpus_index="item_id", num_items=n_items)
    uu = np.arange(n_users)
    metrics = run_kg_experiment(
        {"model": "CKE", "embedding_dim": 16, "kg_dim": 8,
         "num_users": n_users, "num_items": n_items,
         "n_entities": n_items + n_blocks, "n_relations": 2,
         "learning_rate": 5e-2, "epochs": 10, "patience": 6,
         "batch_size": 128, "num_negs": 2, "monitor": "Recall(k=20)",
         "lr_decay_factor": 1.0, "reload_best_on_plateau": False},
        fm, {"user_id": tr_users.astype(np.int32),
             "item_id": tr_items.astype(np.int32)},
        {"item_id": np.arange(n_items, dtype=np.int32)}, kg,
        {"user_id": uu.astype(np.int32)}, uu, train_u2i, valid_u2i,
        device=device)
    print("CKE knowledge retrieval:", metrics)
    assert metrics["Recall(k=20)"] > 0.5, metrics
    return metrics


if __name__ == "__main__":
    run_cli(main)
