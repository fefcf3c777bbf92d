"""Full-softmax CE over a large catalog through the flash-CE kernel (B2)
(`examples/large_vocab_flash_ce.py`).

At catalog sizes the (batch, vocab) logits of the plain full-softmax loss
stop fitting (4 GB at B = 1024 × V = 1M in f32). Kernel B2
(`ops/fused_ce.py`, `csrc/fused_ce.cu`) computes the same loss and
gradients with an online logsumexp over corpus tiles, so the logits never
exist. The one-call pipeline routes to it above 150k items;
``fused_ce: True`` forces it at any size, as here (on the CPU the kernel's
plain version runs).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from recbox_tpu_torch.data.sequential import leave_one_out_split
from recbox_tpu_torch.examples import run_cli
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.quick_start import run_sequential_experiment


def main(device=None) -> Dict[str, float]:
    rng = np.random.default_rng(3)
    n_items = 50
    seqs = {}
    for u in range(400):   # cyclic-walk sessions: next item is predictable
        start = rng.integers(1, n_items + 1)
        seqs[u] = np.array([(start + k - 1) % n_items + 1
                            for k in range(12)])
    train, valid, test = leave_one_out_split(seqs, max_len=10)
    fm = FeatureMap(
        "demo_flash_ce", (FeatureSpec("item_id", "categorical",
                                      source="item", vocab_size=n_items + 1,
                                      embedding_dim=32),),
        query_index="user_id", corpus_index="item_id",
        num_items=n_items + 1)
    metrics = run_sequential_experiment(
        {"model": "SASRec", "embedding_dim": 32, "max_seq_len": 10,
         "n_layers": 1, "n_heads": 2, "dropout": 0.0,
         "compute_dtype": "bfloat16",       # the tensor cores' precision
         "fused_ce": True,                  # force the flash-CE route
         "learning_rate": 5e-3, "epochs": 8, "batch_size": 256,
         "monitor": "NDCG(k=10)", "lr_decay_factor": 1.0,
         "reload_best_on_plateau": False, "patience": 8},
        fm, train, valid, test, device=device)
    print("SASRec via flash-CE:", metrics)
    assert metrics["test_Recall(k=10)"] > 0.7, metrics
    return metrics


if __name__ == "__main__":
    run_cli(main)
