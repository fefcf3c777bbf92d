"""Three-stage cascade as one call: matching → ranking → reranking.

`run_cascade_experiment(dataset, matcher=..., ranker=..., reranker=...)`
runs the cascade from one interaction file with a leakage-clean protocol
(`examples/cascade_three_stage.py`); also reachable from the CLI,
``python -m recbox_tpu_torch.run --config=<dir> --expid=<id>`` with
``model: cascade`` and ``dataset: <name>`` in the expid config.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import numpy as np

from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.quick_start import run_cascade_experiment

KEYS = ("stage1_Recall(k=20)", "stage1_test_Recall(k=20)",
        "candidate_recall", "stage2_AUC", "stage2_logloss",
        "list_matcher_NDCG@5", "list_ranker_NDCG@5", "stage3_NDCG@5")


def generate_dataset(root, name, users=240, items=160, blocks=4,
                     per_user=24, seed=0):
    """Synthetic atomic dataset with planted block structure (each user
    prefers one item block; within-block popularity skewed 3:1)."""
    rng = np.random.default_rng(seed)
    ub = rng.integers(0, blocks, users)
    ib = np.arange(items) % blocks
    rows = []
    for u in range(users):
        block_items = np.flatnonzero(ib == ub[u])
        w = np.where(block_items % 2 == 0, 3.0, 1.0)
        w = w / w.sum()
        chosen = rng.choice(block_items,
                            size=min(int(per_user * 0.8), len(block_items)),
                            replace=False, p=w)
        noise = rng.choice(np.flatnonzero(ib != ub[u]),
                           size=per_user - len(chosen), replace=False)
        for t, it in enumerate(list(chosen) + list(noise)):
            rows.append((u, it, 1, t))
    rng.shuffle(rows)
    folder = os.path.join(root, name)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, f"{name}.inter"), "w") as fh:
        fh.write("user_id:token\titem_id:token\trating:float\t"
                 "timestamp:float\n")
        for u, i, r, t in rows:
            fh.write(f"{u}\t{i}\t{r}\t{t}\n")


def main(device=None) -> Dict[str, float]:
    with tempfile.TemporaryDirectory(prefix="cascade_example_") as root:
        generate_dataset(root, "casc_demo")
        result = run_cascade_experiment(
            "casc_demo", matcher="MF", ranker="DCN", reranker="PRM",
            data_dir=root, order="RO",
            matcher_epochs=4, ranker_epochs=2, reranker_epochs=3,
            candidates=50, list_len=10, embedding_dim=16, batch_size=256,
            topk_eval=(5, 10), device=device)

    print("\n=== cascade MF -> DCN -> PRM (one call) ===")
    for key in KEYS:
        print(f"  {key:28s} {result[key]:.4f}")
    assert result["candidate_recall"] > 0.5
    assert result["stage2_AUC"] > 0.6
    assert result["stage3_NDCG@5"] > result["list_ranker_NDCG@5"]
    print("cascade example OK: reranker beats the ranker order it was fed")
    return {key: result[key] for key in KEYS}


if __name__ == "__main__":
    run_cli(main)
