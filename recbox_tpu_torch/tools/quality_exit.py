"""The quality exits of the DeepFM and SASRec slices: the JAX package's
parity runners, run through the port's `fit`.

    python3 -m recbox_tpu_torch.tools.quality_exit --device cpu
    python3 -m recbox_tpu_torch.tools.quality_exit --models deepfm \\
        --seeds 2024 1 --device cuda

The data are the JAX package's offline synthetic sets, written as atomic
files into a temporary directory by copies of its generators (the same
rng calls and seeds as `tools/parity_gen_ctr.py` and
`tools/parity_gen_seq.py`):

  synthctr: 200 users in 4 blocks, 300 items in 4 blocks, 20,000 clicks
      whose logit is +1.5 where the user's block is the item's, else -1.5;
  synthseq: 400 users of 30 interactions over 200 items, each next item
      the current one's fixed successor with probability 0.85.

The runs are `tools/parity_run_ours_deepfm.py` (DeepFM dim 16, MLP 64-32,
dropout 0.1, Adam 1e-3, batch 512, 30 epochs, patience 10, no plateau
decay, monitor valid AUC, a 80/10/10 split) and
`tools/parity_run_ours_sasrec.py` (SASRec dim 32, L 20, 1 layer, 2 heads,
dropout 0.2, full-softmax CE through `full_scores`, leave-one-out, monitor
valid NDCG@10), with every seed of the runner (the split's permutation,
the loader's shuffle, the trainer's seed) and the model's initial draw
taken from ``--seed``. Each run prints one JSON line with its valid and
test metrics; the last line holds the medians over the seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from typing import Dict

import numpy as np
import torch

__all__ = ["gen_ctr", "gen_seq", "run_deepfm", "run_sasrec", "main"]


def gen_ctr(out_dir: str) -> str:
    """`tools/parity_gen_ctr.py` into ``out_dir/synthctr/synthctr.inter``;
    returns the dataset's directory."""
    rng = np.random.default_rng(5)
    num_users, num_items, n = 200, 300, 20000
    ub = rng.integers(0, 4, num_users)
    ib = np.arange(num_items) % 4
    u = rng.integers(0, num_users, n)
    i = rng.integers(0, num_items, n)
    logit = np.where(ub[u] == ib[i], 1.5, -1.5)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)
    data_dir = os.path.join(out_dir, "synthctr")
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "synthctr.inter"), "w") as fh:
        fh.write("user_id:token\titem_id:token\tlabel:float\n")
        for k in range(n):
            fh.write(f"{u[k]}\t{i[k]}\t{y[k]}\n")
    return data_dir


def gen_seq(out_dir: str) -> str:
    """`tools/parity_gen_seq.py` into ``out_dir/synthseq/synthseq.inter``;
    returns the dataset's directory."""
    rng = np.random.default_rng(11)
    num_users, num_items, seq_len = 400, 200, 30
    succ = rng.permutation(num_items)
    rows = []
    for u in range(num_users):
        it = rng.integers(0, num_items)
        for t in range(seq_len):
            rows.append((u, it, 1, t))
            it = succ[it] if rng.random() < 0.85 \
                else rng.integers(0, num_items)
    data_dir = os.path.join(out_dir, "synthseq")
    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, "synthseq.inter"), "w") as fh:
        fh.write("user_id:token\titem_id:token\trating:float\t"
                 "timestamp:float\n")
        for u, i, r, t in rows:
            fh.write(f"{u}\t{i}\t{r}\t{t}\n")
    return data_dir


def run_deepfm(data_dir: str, seed: int, device: str, epochs: int = 30
               ) -> Dict[str, Dict[str, float]]:
    from recbox_tpu_torch.data import ArrayLoader
    from recbox_tpu_torch.data.atomic import load_atomic_dataset
    from recbox_tpu_torch.evaluation import CTREvaluator
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.ranking import DeepFM
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import Trainer, TrainerConfig

    ds = load_atomic_dataset(data_dir, "synthctr")
    arrays = {"user_id": ds.inter["user_id"].astype(np.int32),
              "item_id": ds.inter["item_id"].astype(np.int32),
              "label": ds.inter["label"].astype(np.float32)}
    n = len(arrays["label"])
    idx = np.random.default_rng(seed).permutation(n)
    n_va = int(0.1 * n)
    n_tr = n - 2 * n_va
    tr, va, te = np.split(idx, [n_tr, n_tr + n_va])
    train = {k: v[tr] for k, v in arrays.items()}
    valid = {k: v[va] for k, v in arrays.items()}
    test = {k: v[te] for k, v in arrays.items()}
    fm = FeatureMap("sctr", (
        FeatureSpec("user_id", "categorical", vocab_size=ds.num_users,
                    embedding_dim=16),
        FeatureSpec("item_id", "categorical", vocab_size=ds.num_items,
                    embedding_dim=16)), labels=("label",))
    model = DeepFM(fm, embedding_dim=16, hidden_units=(64, 32), dropout=0.1,
                   generator=torch.Generator(device=device).manual_seed(seed),
                   device=device)
    cfg = TrainerConfig(seed=seed, learning_rate=1e-3, epochs=epochs,
                        patience=10, monitor="AUC", lr_decay_factor=1.0,
                        reload_best_on_plateau=False)
    ev = CTREvaluator(valid, label="label", metrics=["AUC", "logloss"])
    trainer = Trainer(model, lambda o, b: binary_crossentropy(o, b["label"]),
                      cfg, eval_fn=ev, device=device)
    loader = ArrayLoader(train, batch_size=512, drop_last=True, seed=seed)
    valid_metrics = trainer.fit(loader)
    test_ev = CTREvaluator(test, label="label", metrics=["AUC", "logloss"])
    return {"valid": valid_metrics, "test": test_ev(trainer),
            "best_epoch": trainer.monitor.best_epoch, "steps": trainer.step}


def _eval_split(trainer, split) -> Dict[str, float]:
    scores = trainer.apply(
        {"item_seq": split["item_seq"], "seq_len": split["seq_len"]},
        method=trainer.model.full_scores).float().cpu().numpy()
    order = np.argsort(-scores, axis=1)[:, :10]
    hits = order == split["item_id"][:, None]
    pos = np.where(hits.any(1), hits.argmax(1), -1)
    ndcg = np.where(pos >= 0, 1.0 / np.log2(np.maximum(pos, 0) + 2.0), 0.0)
    return {"Recall10": float(hits.any(1).mean()),
            "NDCG10": float(ndcg.mean())}


def run_sasrec(data_dir: str, seed: int, device: str, epochs: int = 30,
               fused: bool = False) -> Dict[str, Dict[str, float]]:
    """The SASRec synthseq run; with ``fused``, through the training path
    of the 1M-item trainer instead of `full_scores`: the same full-softmax
    CE by kernel B2 (`fused_ce_loss`, bf16 products) and `fit` in
    `train_steps_fused` calls of 8 steps (a CUDA graph on the card)."""
    from recbox_tpu_torch.data import (
        ArrayLoader, group_user_sequences, leave_one_out_split,
    )
    from recbox_tpu_torch.data.atomic import load_atomic_dataset
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.sequential import SASRec
    from recbox_tpu_torch.ops.losses import full_softmax_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig

    ds = load_atomic_dataset(data_dir, "synthseq")
    inter = ds.to_interactions(rating_field="rating", time_field="timestamp")
    seqs = group_user_sequences(inter.user_ids, inter.item_ids,
                                inter.timestamps)
    train, valid, test = leave_one_out_split(seqs, max_len=20)
    n_items = ds.num_items  # ids 1..N-1, 0 = PAD
    fm = FeatureMap("sseq", (FeatureSpec(
        "item_id", "categorical", source="item", vocab_size=n_items,
        embedding_dim=32),), query_index="user_id", corpus_index="item_id",
        num_items=n_items)
    model = SASRec(fm, embedding_dim=32, max_seq_len=20, n_layers=1,
                   n_heads=2, dropout=0.2,
                   generator=torch.Generator(device=device).manual_seed(seed),
                   device=device)
    cfg = TrainerConfig(seed=seed, learning_rate=1e-3, epochs=epochs,
                        patience=10, monitor="NDCG10", lr_decay_factor=1.0,
                        reload_best_on_plateau=False,
                        fused_steps=8 if fused else 1)
    loss = (lambda o, b: o) if fused else \
        (lambda o, b: full_softmax_loss(o, b["item_id"]))
    trainer = Trainer(model, loss, cfg,
                      eval_fn=lambda tr: _eval_split(tr, valid),
                      train_method="fused_ce_loss" if fused else "full_scores",
                      device=device)
    loader = ArrayLoader(train, batch_size=512, drop_last=True, seed=seed)
    valid_metrics = trainer.fit(loader)
    return {"valid": valid_metrics, "test": _eval_split(trainer, test),
            "best_epoch": trainer.monitor.best_epoch, "steps": trainer.step}


RUNS = {"deepfm": (gen_ctr, run_deepfm), "sasrec": (gen_seq, run_sasrec)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=list(RUNS),
                    choices=list(RUNS))
    ap.add_argument("--seeds", nargs="+", type=int,
                    default=[2024, 1, 2, 3, 4])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    medians = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.models:
            gen, run = RUNS[name]
            data_dir = gen(tmp)
            tests = []
            for seed in args.seeds:
                res = run(data_dir, seed, args.device)
                tests.append(res["test"])
                print(json.dumps({"model": name, "seed": seed,
                                  "device": args.device, **res}),
                      flush=True)
            medians[name] = {k: statistics.median(t[k] for t in tests)
                             for k in tests[0]}
    print(json.dumps({"medians": medians, "seeds": args.seeds,
                      "device": args.device}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
