"""The quality exits: the JAX package's parity runners, run through the
port's `fit`.

    python3 -m recbox_tpu_torch.tools.quality_exit --device cpu
    python3 -m recbox_tpu_torch.tools.quality_exit --models deepfm \\
        --seeds 2024 1 --device cuda
    python3 -m recbox_tpu_torch.tools.quality_exit --models bpr lightgcn \\
        --dataset synth --device cpu [--init-from DIR]
    python3 -m recbox_tpu_torch.tools.quality_exit --models dcnv2 xdeepfm
    python3 -m recbox_tpu_torch.tools.quality_exit --models cascade \\
        --seeds 2024

The data are the JAX package's offline synthetic sets, written as atomic
files into a temporary directory by copies of its generators (the same
rng calls and seeds as `tools/parity_gen_ctr.py` and
`tools/parity_gen_seq.py`):

  synthctr: 200 users in 4 blocks, 300 items in 4 blocks, 20,000 clicks
      whose logit is +1.5 where the user's block is the item's, else -1.5;
  synthseq: 400 users of 30 interactions over 200 items, each next item
      the current one's fixed successor with probability 0.85;
  synth (`tools/parity_gen_data.py`): 300 users in 8 blocks, 400 items, 15
      to 29 items a user from its own block and 3 from others;
  ml1m_scale (`tools/parity_gen_ml1m_scale.py`): MovieLens-1M's shape,
      6040 users, 3706 items, 834,915 interactions in 24 blocks, Zipf
      popularity, lognormal activity (``--dataset ml1m_scale``).

The runs are `tools/parity_run_ours_deepfm.py` (DeepFM dim 16, MLP 64-32,
dropout 0.1, Adam 1e-3, batch 512, 30 epochs, patience 10, no plateau
decay, monitor valid AUC, a 80/10/10 split) and
`tools/parity_run_ours_sasrec.py` (SASRec dim 32, L 20, 1 layer, 2 heads,
dropout 0.2, full-softmax CE through `full_scores`, leave-one-out, monitor
valid NDCG@10), DCNv2 ('stacked') and xDeepFM (its CIN with recbole's
relu) in DeepFM's place at DeepFM's knobs (`docs/QUALITY_PARITY.md:186-190`),
with every seed of the runner (the split's permutation,
the loader's shuffle, the trainer's seed) and the model's initial draw
taken from ``--seed``. The matching runs are
`tools/parity_run_ours_bpr.py` (MF dim 32, BPR over one negative a
positive drawn anew each epoch with the user's train items excluded,
Adam 1e-3, batch 512, 30 epochs, patience 10, no plateau decay, monitor
valid Recall@20, a (0.8, 0.1, 0.1) 'RO' split by user, the loader's seed
99) and `tools/parity_run_ours_lightgcn.py` (LightGCN, 2 hops, over the
train edges, the loader seeded like the split): the test metrics are
Recall@20 and NDCG@20 of a full sort with the train and valid items
masked. Their seeds: the split's permutation, the trainer's and the
model's draw (and LightGCN's loader) from ``--seed``.

``--models cascade`` runs `run_cascade_experiment("ml1m_scale",
matcher="MF", ranker="DCN", reranker="PRM")` on ml1m_scale at
`tools/cascade_ml1m_scale.py`'s knobs (MF 8 epochs, DCN 3 epochs with 2
cross layers and MLP 64-32, PRM 5 epochs with 4 heads, 200 candidates,
lists of 50, dim 32, an 'RO' split, Recall@20 / NDCG@20), printing every
metric and the seconds of each stage.

``--init-from DIR`` pairs a run with JAX: it loads the JAX model's
initial params from ``DIR/<model>_seed<seed>.npz`` (``bpr_ml1m_scale``
for BPR on ml1m_scale), flattened to '/'-joined keys, as
`tests/test_torch_exit_pairing.py` writes them when run as a script, and
moves them onto the port's model (`interop.from_jax_params`) before
`fit`. ``--dropout 0`` (synthctr runs) removes the one difference a
paired run keeps, the dropout masks (Philox against threefry). Each run prints one JSON line with its valid and test metrics; the
last line holds the medians over the seeds.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["gen_ctr", "gen_seq", "gen_synth", "gen_ml1m_scale",
           "run_deepfm", "run_ctr", "run_sasrec", "run_bpr",
           "run_lightgcn", "run_cascade", "ctr_trainer", "matching_setup",
           "matching_trainer", "load_init", "main"]


_INTER_HEADER = ("user_id:token\titem_id:token\trating:float\t"
                 "timestamp:float\n")


def _write_inter(out_dir: str, name: str, header: str, rows) -> str:
    """``rows`` into ``out_dir/<name>/<name>.inter``, written to a
    temporary name and moved into place; returns the dataset's
    directory."""
    data_dir = os.path.join(out_dir, name)
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, f"{name}.inter")
    with open(path + ".tmp", "w") as fh:
        fh.write(header)
        for row in rows:
            fh.write("\t".join(str(x) for x in row) + "\n")
    os.replace(path + ".tmp", path)
    return data_dir


def load_init(init_from: Optional[str], name: str, seed: int,
              model: torch.nn.Module) -> None:
    """Load ``init_from/<name>_seed<seed>.npz`` (a JAX model's initial
    params, '/'-joined keys) into ``model``; nothing when ``init_from`` is
    None."""
    if init_from is None:
        return
    from recbox_tpu_torch.interop import from_jax_params
    tree: dict = {}
    with np.load(os.path.join(init_from, f"{name}_seed{seed}.npz")) as flat:
        for key in flat.files:
            *path, leaf = key.split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    model.load_state_dict(from_jax_params(tree, model))


def gen_ctr(out_dir: str) -> str:
    """`tools/parity_gen_ctr.py` into ``out_dir/synthctr/synthctr.inter``;
    returns the dataset's directory. Every generator writes the tool's file
    byte for byte, to a temporary name moved into place."""
    rng = np.random.default_rng(5)
    num_users, num_items, n = 200, 300, 20000
    ub = rng.integers(0, 4, num_users)
    ib = np.arange(num_items) % 4
    u = rng.integers(0, num_users, n)
    i = rng.integers(0, num_items, n)
    logit = np.where(ub[u] == ib[i], 1.5, -1.5)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)
    return _write_inter(out_dir, "synthctr",
                        "user_id:token\titem_id:token\tlabel:float\n",
                        zip(u, i, y))


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
    return _write_inter(out_dir, "synthseq", _INTER_HEADER, rows)


def gen_synth(out_dir: str) -> str:
    """`tools/parity_gen_data.py` into ``out_dir/synth/synth.inter``."""
    rng = np.random.default_rng(7)
    num_users, num_items, n_blocks = 300, 400, 8
    ub = rng.integers(0, n_blocks, num_users)
    ib = np.arange(num_items) % n_blocks
    rows = []
    for u in range(num_users):
        block_items = np.flatnonzero(ib == ub[u])
        k = rng.integers(15, 30)
        chosen = rng.choice(block_items, size=min(k, len(block_items)),
                            replace=False)
        noise = rng.choice(np.flatnonzero(ib != ub[u]), size=3,
                           replace=False)
        for t, it in enumerate(list(chosen) + list(noise)):
            rows.append((u, it, 1, t))
    rng.shuffle(rows)
    return _write_inter(out_dir, "synth", _INTER_HEADER, rows)


def gen_ml1m_scale(out_dir: str) -> str:
    """`tools/parity_gen_ml1m_scale.py` into
    ``out_dir/ml1m_scale/ml1m_scale.inter``."""
    rng = np.random.default_rng(7)
    num_users, num_items, n_blocks = 6040, 3706, 24
    ub = rng.integers(0, n_blocks, num_users)
    ib = np.arange(num_items) % n_blocks
    pop = 1.0 / (1.0 + np.argsort(np.argsort(rng.random(num_items))))
    rows = []
    for u in range(num_users):
        k = int(np.clip(rng.lognormal(4.6, 0.8), 20, 2000))
        block_items = np.flatnonzero(ib == ub[u])
        p = pop[block_items] / pop[block_items].sum()
        n_block = min(int(k * 0.85), len(block_items))
        chosen = rng.choice(block_items, size=n_block, replace=False, p=p)
        others = np.flatnonzero(ib != ub[u])
        po = pop[others] / pop[others].sum()
        noise = rng.choice(others, size=max(1, k - n_block), replace=False,
                           p=po)
        for t, it in enumerate(list(chosen) + list(noise)):
            rows.append((u, it, 1, t))
    rng.shuffle(rows)
    return _write_inter(out_dir, "ml1m_scale", _INTER_HEADER, rows)


def _fit(trainer, loader, test_fn) -> Dict[str, Dict[str, float]]:
    """`fit`, then the test metrics of the best evaluation's weights."""
    valid_metrics = trainer.fit(loader)
    return {"valid": valid_metrics, "test": test_fn(trainer),
            "best_epoch": trainer.monitor.best_epoch, "steps": trainer.step}


# the synthctr models and their arguments beyond the runner's (embedding
# 16, MLP 64-32, dropout 0.1): DeepFM's runner, and the DCNv2 / xDeepFM
# head-to-head of `docs/QUALITY_PARITY.md:186-190` (DCNv2 'stacked',
# xDeepFM with recbole's per-layer CIN relu)
CTR_MODELS = {"deepfm": ("DeepFM", {}),
              "dcnv2": ("DCNv2", {"model_structure": "stacked"}),
              "xdeepfm": ("xDeepFM", {"cin_activation": "relu"})}


def run_ctr(kind: str, data_dir: str, seed: int, device: str,
            epochs: int = 30, init_from: Optional[str] = None,
            dropout: float = 0.1) -> Dict[str, Dict[str, float]]:
    """The synthctr run of ``kind`` (a key of `CTR_MODELS`) through the
    port: `tools/parity_run_ours_deepfm.py`, its model swapped for
    DCNv2 / xDeepFM."""
    return _fit(*ctr_trainer(kind, data_dir, seed, device, epochs,
                             init_from, dropout))


def run_deepfm(data_dir: str, seed: int, device: str, epochs: int = 30,
               init_from: Optional[str] = None, dropout: float = 0.1
               ) -> Dict[str, Dict[str, float]]:
    """`tools/parity_run_ours_deepfm.py` through the port."""
    return run_ctr("deepfm", data_dir, seed, device, epochs, init_from,
                   dropout)


def ctr_trainer(kind: str, data_dir: str, seed: int, device: str,
                epochs: int = 30, init_from: Optional[str] = None,
                dropout: float = 0.1):
    """(trainer, train loader, test metrics function) of the synthctr run
    of ``kind`` (a key of `CTR_MODELS`); ``dropout`` is the runner's 0.1
    unless a pairing diagnosis asks for 0 (`main`'s ``--dropout``)."""
    from recbox_tpu_torch.data import ArrayLoader
    from recbox_tpu_torch.data.atomic import load_atomic_dataset
    from recbox_tpu_torch.evaluation import CTREvaluator
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models import ranking
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
    cls_name, extra = CTR_MODELS[kind]
    model = getattr(ranking, cls_name)(
        fm, embedding_dim=16, hidden_units=(64, 32), dropout=dropout,
        generator=torch.Generator(device=device).manual_seed(seed),
        device=device, **extra)
    load_init(init_from, kind, seed, model)
    cfg = TrainerConfig(seed=seed, learning_rate=1e-3, epochs=epochs,
                        patience=10, monitor="AUC", lr_decay_factor=1.0,
                        reload_best_on_plateau=False)
    ev = CTREvaluator(valid, label="label", metrics=["AUC", "logloss"])
    trainer = Trainer(model, lambda o, b: binary_crossentropy(o, b["label"]),
                      cfg, eval_fn=ev, device=device)
    loader = ArrayLoader(train, batch_size=512, drop_last=True, seed=seed)
    return trainer, loader, CTREvaluator(test, label="label",
                                         metrics=["AUC", "logloss"])


# the cascade at ml1m_scale: `tools/cascade_ml1m_scale.py`'s knobs
# (:25, :103, :245-246, :320) and its 'RO' split and metrics (:86, :117)
# through `run_cascade_experiment` (whose default split would be 'TO' on
# these timestamps, which put each user's off-block items last)
CASCADE_KNOBS = dict(embedding_dim=32, matcher_epochs=8, ranker_epochs=3,
                     reranker_epochs=5, candidates=200, list_len=50,
                     num_cross_layers=2, hidden_units=(64, 32), n_heads=4,
                     order="RO", metrics=("Recall(k=20)", "NDCG(k=20)"))


def run_cascade(data_dir: str, seed: int, device: str,
                init_from: Optional[str] = None) -> Dict[str, Any]:
    """`run_cascade_experiment("ml1m_scale", matcher="MF", ranker="DCN",
    reranker="PRM")` at `CASCADE_KNOBS`; its metrics as ``test`` and the
    seconds of each stage as ``timings``."""
    if init_from is not None:
        raise ValueError("the cascade runs unpaired")
    from recbox_tpu_torch.quick_start import run_cascade_experiment
    timings: Dict[str, float] = {}
    result = run_cascade_experiment(
        "ml1m_scale", matcher="MF", ranker="DCN", reranker="PRM",
        data_dir=os.path.dirname(os.path.normpath(data_dir)), seed=seed,
        device=device, timings=timings, **CASCADE_KNOBS)
    return {"test": result, "timings": timings}


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
               fused: bool = False, init_from: Optional[str] = None
               ) -> Dict[str, Dict[str, float]]:
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
    load_init(init_from, "sasrec", seed, model)
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
    return _fit(trainer, loader, lambda tr: _eval_split(tr, test))


def matching_setup(data_dir: str, seed: int):
    """The matching runners' data: (dataset name, feature map, train
    arrays, corpus, train / valid / test user -> items, train
    interactions, users, items), the split by ``seed``."""
    from recbox_tpu_torch.data.atomic import load_atomic_dataset
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec

    name = os.path.basename(os.path.normpath(data_dir))
    ds = load_atomic_dataset(data_dir, name)
    inter = ds.to_interactions(rating_field="rating", time_field="timestamp")
    train, valid, test = inter.split_ratio((0.8, 0.1, 0.1), order="RO",
                                           group_by_user=True, seed=seed)
    fm = FeatureMap(name, (
        FeatureSpec("user_id", "categorical", "user",
                    vocab_size=ds.num_users, embedding_dim=32),
        FeatureSpec("item_id", "categorical", "item",
                    vocab_size=ds.num_items, embedding_dim=32)),
        query_index="user_id", corpus_index="item_id",
        num_items=ds.num_items)

    def u2i(split):
        out: Dict[int, list] = {}
        for u, i in zip(split.user_ids, split.item_ids):
            out.setdefault(int(u), []).append(int(i))
        return out

    corpus = {"item_id": np.arange(ds.num_items, dtype=np.int32)}
    train_arrays = {"user_id": train.user_ids.astype(np.int32),
                    "item_id": train.item_ids.astype(np.int32)}
    return (name, fm, train_arrays, corpus, u2i(train), u2i(valid),
            u2i(test), train, ds.num_users, ds.num_items)


def matching_trainer(kind: str, data_dir: str, seed: int, device: str,
                     epochs: int = 30, init_from: Optional[str] = None):
    """(trainer, train loader, test metrics function) of the MF-BPR
    (``kind`` 'bpr') or LightGCN run."""
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.evaluation import RetrievalEvaluator
    from recbox_tpu_torch.models.matching import (
        MF, LightGCN, build_norm_edges,
    )
    from recbox_tpu_torch.ops.losses import get_matching_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig

    (name, fm, train_arrays, corpus, train_u2i, valid_u2i, test_u2i,
     train, n_users, n_items) = matching_setup(data_dir, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "bpr":
        model = MF(fm, embedding_dim=32, emb_init_scheme="normal",
                   generator=gen, device=device)
        loader_seed = 99
    else:
        eu, ei, c = build_norm_edges(train.user_ids, train.item_ids,
                                     n_users, n_items)
        model = LightGCN(fm, embedding_dim=32, num_users=n_users,
                         num_items=n_items, n_layers=2, edge_users=eu,
                         edge_items=ei, edge_coefs=c,
                         emb_init_scheme="normal", generator=gen,
                         device=device)
        loader_seed = seed
    load_init(init_from, kind if name == "synth" else f"{kind}_{name}",
              seed, model)
    loader = MatchingLoader(fm, train_arrays, corpus, batch_size=512,
                            num_negs=1, seed=loader_seed, exclude_seen=True)
    metrics = ["Recall(k=20)", "NDCG(k=20)"]
    vu = np.array(sorted(valid_u2i), np.int32)
    ev = RetrievalEvaluator({"user_id": vu}, corpus, vu, train_u2i,
                            valid_u2i, metrics=metrics)
    cfg = TrainerConfig(seed=seed, learning_rate=1e-3, epochs=epochs,
                        patience=10, monitor="Recall(k=20)",
                        lr_decay_factor=1.0, reload_best_on_plateau=False)
    bpr = get_matching_loss("PairwiseLogisticLoss")
    trainer = Trainer(model, lambda o, b: bpr(o), cfg, eval_fn=ev,
                      device=device)
    # the test protocol masks train and valid (recbole's full sort)
    hist = {u: train_u2i.get(u, []) + valid_u2i.get(u, [])
            for u in set(train_u2i) | set(valid_u2i)}
    tu = np.array(sorted(test_u2i), np.int32)
    return trainer, loader, RetrievalEvaluator(
        {"user_id": tu}, corpus, tu, hist, test_u2i, metrics=metrics)


def run_bpr(data_dir: str, seed: int, device: str, epochs: int = 30,
            init_from: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    """`tools/parity_run_ours_bpr.py` through the port (MF-BPR)."""
    return _fit(*matching_trainer("bpr", data_dir, seed, device, epochs,
                                  init_from))


def run_lightgcn(data_dir: str, seed: int, device: str, epochs: int = 30,
                 init_from: Optional[str] = None
                 ) -> Dict[str, Dict[str, float]]:
    """`tools/parity_run_ours_lightgcn.py` through the port."""
    return _fit(*matching_trainer("lightgcn", data_dir, seed, device,
                                  epochs, init_from))


RUNS = {"deepfm": (gen_ctr, run_deepfm), "sasrec": (gen_seq, run_sasrec),
        "bpr": (gen_synth, run_bpr), "lightgcn": (gen_synth, run_lightgcn),
        "dcnv2": (gen_ctr, functools.partial(run_ctr, "dcnv2")),
        "xdeepfm": (gen_ctr, functools.partial(run_ctr, "xdeepfm")),
        "cascade": (gen_ml1m_scale, run_cascade)}
MATCHING_DATA = {"synth": gen_synth, "ml1m_scale": gen_ml1m_scale}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=["deepfm", "sasrec"],
                    choices=list(RUNS))
    ap.add_argument("--seeds", nargs="+", type=int,
                    default=[2024, 1, 2, 3, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dataset", default="synth", choices=list(MATCHING_DATA),
                    help="the matching runs' data (bpr, lightgcn)")
    ap.add_argument("--init-from", default=None,
                    help="a directory of <model>_seed<seed>.npz: the JAX "
                         "models' initial params, loaded before fit")
    ap.add_argument("--dropout", type=float, default=None,
                    help="the synthctr runs' dropout (the runner's 0.1 by "
                         "default): 0 pairs a run with JAX's to rounding, "
                         "the two packages' dropout streams being apart")
    args = ap.parse_args(argv)
    medians = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.models:
            gen, run = RUNS[name]
            if name in ("bpr", "lightgcn"):
                gen = MATCHING_DATA[args.dataset]
            data_dir = gen(tmp)
            tests = []
            kw = {} if args.dropout is None or name not in CTR_MODELS \
                else {"dropout": args.dropout}
            for seed in args.seeds:
                res = run(data_dir, seed, args.device,
                          init_from=args.init_from, **kw)
                tests.append(res["test"])
                print(json.dumps({"model": name, "seed": seed,
                                  "device": args.device, **res}),
                      flush=True)
            medians[name] = {k: statistics.median(float(t[k]) for t in tests)
                             for k in tests[0]}
    print(json.dumps({"medians": medians, "seeds": args.seeds,
                      "device": args.device, "dataset": args.dataset,
                      "init_from": args.init_from,
                      "dropout": args.dropout}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
