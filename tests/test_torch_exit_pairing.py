"""Paired quality exits: the port's exit models start from the JAX runners'
initial weights.

The JAX runners (`tools/parity_run_ours_{deepfm,sasrec,bpr,lightgcn}.py`)
draw their models' initial params from the trainer's seed (threefry);
the port draws its own from the same seed, another stream. Run as a
script, this file builds each runner's model exactly as the runner does
(its data, its split, its loader, its `TrainerConfig`, with the seed in
place of 2024), inits it through the runner's trainer and writes the
params, flattened to '/'-joined keys, to ``<out>/<model>_seed<seed>.npz``
(``bpr_ml1m_scale`` for MF-BPR on ml1m_scale)::

    env JAX_PLATFORMS=cpu python -m tests.test_torch_exit_pairing \\
        --out DIR [--models deepfm dcnv2 xdeepfm fignn eulernet sasrec bpr \\
        lightgcn] \\
        [--seeds 2024 1 2 3 4] [--dataset synth|ml1m_scale]

``python3 -m recbox_tpu_torch.tools.quality_exit --init-from DIR`` then
trains the port from them. The data come from the port's copies of the
generators (`quality_exit.gen_*`), which write the JAX tools' files byte
for byte. Dropout masks still differ (Philox against threefry); with
``--dropout 0`` (synthctr models) both sides drop nothing, and ``--fit``
also trains each JAX runner and prints its test metrics, one JSON line a
run, for ``quality_exit --dropout 0 --init-from DIR`` to be held to.

The test: DeepFM, DCNv2, xDeepFM, FiGNN and EulerNet on synthctr and
MF-BPR on synth at
seed 2024, the port's exit trainer loaded from the dumped params gives
the JAX runner's
validation metrics before the first step within 1e-6 (AUC / logloss;
Recall@20 / NDCG@20), and every port parameter is transplanted; at
dropout 0 a paired DCNv2 run follows JAX's for three epochs.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest

from recbox_tpu.data import ArrayLoader, MatchingLoader
from recbox_tpu.data.atomic import load_atomic_dataset
from recbox_tpu.data.sequential import (
    group_user_sequences, leave_one_out_split,
)
from recbox_tpu.evaluation import CTREvaluator, RetrievalEvaluator
from recbox_tpu.features import FeatureMap, FeatureSpec
from recbox_tpu.models.matching.graph import LightGCN, build_norm_edges
from recbox_tpu.models.matching.two_tower import MF
from recbox_tpu.models.ranking.ctr import DCNv2, DeepFM, xDeepFM
from recbox_tpu.models.ranking.ctr_extended import EulerNet, FiGNN
from recbox_tpu.models.sequential.models import SASRec
from recbox_tpu.ops import (
    binary_crossentropy, full_softmax_loss, get_matching_loss,
)
from recbox_tpu.training import Trainer, TrainerConfig
from recbox_tpu_torch.tools import quality_exit as qe


def _cfg(seed, monitor, epochs=30):
    return TrainerConfig(rng_impl="threefry", seed=seed, learning_rate=1e-3,
                         epochs=epochs, patience=10, monitor=monitor,
                         lr_decay_factor=1.0, reload_best_on_plateau=False)


def _ctr_split(data_dir, seed):
    """synthctr's arrays and the runner's (train, valid, test) split."""
    ds = load_atomic_dataset(data_dir, "synthctr")
    arrays = {"user_id": ds.inter["user_id"].astype(np.int32),
              "item_id": ds.inter["item_id"].astype(np.int32),
              "label": ds.inter["label"].astype(np.float32)}
    n = len(arrays["label"])
    idx = np.random.default_rng(seed).permutation(n)
    n_va = int(0.1 * n)
    n_tr = n - 2 * n_va
    return ds, [{k: v[part] for k, v in arrays.items()}
                for part in np.split(idx, [n_tr, n_tr + n_va])]


def jax_deepfm(data_dir, seed, cls=DeepFM, dropout=0.1, epochs=30,
               mlp=True, **extra):
    """`tools/parity_run_ours_deepfm.py` at ``seed`` (with ``cls`` and its
    ``extra`` arguments in DeepFM's place: the DCNv2 / xDeepFM runs of
    `docs/QUALITY_PARITY.md:186-190`, and without the MLP (``mlp``
    False) `tools/parity_run_ours_ctrx.py`'s FiGNN / EulerNet): (trainer,
    loader, valid evaluator)."""
    ds, (train, valid, _) = _ctr_split(data_dir, seed)
    fm = FeatureMap("sctr", (
        FeatureSpec("user_id", "categorical", vocab_size=ds.num_users,
                    embedding_dim=16),
        FeatureSpec("item_id", "categorical", vocab_size=ds.num_items,
                    embedding_dim=16)), labels=("label",))
    if mlp:
        extra = {"hidden_units": (64, 32), **extra}
    model = cls(feature_map=fm, embedding_dim=16, dropout=dropout, **extra)
    ev = CTREvaluator(valid, label="label", metrics=["AUC", "logloss"])
    trainer = Trainer(model, lambda o, b: binary_crossentropy(o, b["label"]),
                      _cfg(seed, "AUC", epochs), eval_fn=ev)
    loader = ArrayLoader(train, batch_size=512, drop_last=True, seed=seed)
    return trainer, loader, ev


def jax_ctr_fit(trainer, loader, data_dir, seed) -> dict:
    """`fit` of a `jax_deepfm` runner, then its test metrics, as
    `quality_exit` reports a port run."""
    valid = trainer.fit(loader)
    _, (_, _, test) = _ctr_split(data_dir, seed)
    ev = CTREvaluator(test, label="label", metrics=["AUC", "logloss"])
    return {"valid": {k: float(v) for k, v in valid.items()},
            "test": {k: float(v) for k, v in ev(trainer).items()},
            "best_epoch": trainer.monitor.best_epoch,
            "steps": int(trainer.step)}


def jax_sasrec(data_dir, seed):
    """`tools/parity_run_ours_sasrec.py` at ``seed``."""
    ds = load_atomic_dataset(data_dir, "synthseq")
    inter = ds.to_interactions(rating_field="rating", time_field="timestamp")
    seqs = group_user_sequences(inter.user_ids, inter.item_ids,
                                inter.timestamps)
    train, _, _ = leave_one_out_split(seqs, max_len=20)
    fm = FeatureMap("sseq", (FeatureSpec(
        "item_id", "categorical", source="item", vocab_size=ds.num_items,
        embedding_dim=32),), query_index="user_id", corpus_index="item_id",
        num_items=ds.num_items)
    model = SASRec(feature_map=fm, embedding_dim=32, max_seq_len=20,
                   n_layers=1, n_heads=2, dropout=0.2)
    trainer = Trainer(model, lambda o, b: full_softmax_loss(o, b["item_id"]),
                      _cfg(seed, "NDCG10"), train_method="full_scores")
    return trainer, ArrayLoader(train, batch_size=512, drop_last=True,
                                seed=seed), None


def jax_matching(kind, data_dir, seed):
    """`tools/parity_run_ours_{bpr,lightgcn}.py` at ``seed``."""
    name = os.path.basename(os.path.normpath(data_dir))
    ds = load_atomic_dataset(data_dir, name)
    inter = ds.to_interactions(rating_field="rating", time_field="timestamp")
    train, valid, _ = inter.split_ratio((0.8, 0.1, 0.1), order="RO",
                                        group_by_user=True, seed=seed)
    n_users, n_items = ds.num_users, ds.num_items
    fm = FeatureMap(name, (
        FeatureSpec("user_id", "categorical", "user", vocab_size=n_users,
                    embedding_dim=32),
        FeatureSpec("item_id", "categorical", "item", vocab_size=n_items,
                    embedding_dim=32)),
        query_index="user_id", corpus_index="item_id", num_items=n_items)

    def u2i(split):
        out = {}
        for u, i in zip(split.user_ids, split.item_ids):
            out.setdefault(int(u), []).append(int(i))
        return out

    train_u2i, valid_u2i = u2i(train), u2i(valid)
    corpus = {"item_id": np.arange(n_items, dtype=np.int32)}
    arrays = {"user_id": train.user_ids.astype(np.int32),
              "item_id": train.item_ids.astype(np.int32)}
    if kind == "bpr":
        model = MF(feature_map=fm, embedding_dim=32, emb_init_scheme="normal")
        loader_seed = 99
    else:
        eu, ei, c = build_norm_edges(train.user_ids, train.item_ids,
                                     n_users, n_items)
        model = LightGCN(feature_map=fm, embedding_dim=32, num_users=n_users,
                         num_items=n_items, n_layers=2,
                         edge_users=tuple(eu), edge_items=tuple(ei),
                         edge_coefs=tuple(c), emb_init_scheme="normal")
        loader_seed = seed
    loader = MatchingLoader(fm, arrays, corpus, batch_size=512, num_negs=1,
                            seed=loader_seed, exclude_seen=True)
    vu = np.array(sorted(valid_u2i), np.int32)
    ev = RetrievalEvaluator({"user_id": vu}, corpus, vu, train_u2i,
                            valid_u2i, metrics=["Recall(k=20)", "NDCG(k=20)"])
    loss = get_matching_loss("PairwiseLogisticLoss")
    trainer = Trainer(model, lambda o, b: loss(o), _cfg(seed, "Recall(k=20)"),
                      eval_fn=ev)
    return trainer, loader, ev


BUILDERS = {
    "deepfm": (qe.gen_ctr, jax_deepfm),
    "dcnv2": (qe.gen_ctr, lambda d, s, **k: jax_deepfm(
        d, s, DCNv2, model_structure="stacked", **k)),
    "xdeepfm": (qe.gen_ctr, lambda d, s, **k: jax_deepfm(
        d, s, xDeepFM, cin_activation="relu", **k)),
    "fignn": (qe.gen_ctr, lambda d, s, **k: jax_deepfm(
        d, s, FiGNN, mlp=False, gnn_steps=2, att_dim=16, num_heads=2,
        emb_init_scheme="xavier_normal", **k)),
    "eulernet": (qe.gen_ctr, lambda d, s, **k: jax_deepfm(
        d, s, EulerNet, mlp=False, order_layers=(16,), apply_norm=False,
        emb_init_scheme="xavier_normal", **k)),
    "sasrec": (qe.gen_seq, jax_sasrec),
    "bpr": (qe.gen_synth, lambda d, s: jax_matching("bpr", d, s)),
    "lightgcn": (qe.gen_synth, lambda d, s: jax_matching("lightgcn", d, s)),
}


def init_params(trainer, loader) -> dict:
    """The runner's initial params as {'/'-joined key: numpy array}."""
    trainer.init(loader.peek_batch())
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(jax.tree_util.tree_map(np.asarray,
                                fnn.meta.unbox(dict(trainer.params))), "")
    return flat


def dump(out_dir, name, seed, trainer, loader) -> str:
    path = os.path.join(out_dir, f"{name}_seed{seed}.npz")
    np.savez(path, **init_params(trainer, loader))
    return path


@pytest.mark.parametrize("model,gen,port_trainer", [
    ("deepfm", qe.gen_ctr, functools.partial(qe.ctr_trainer, "deepfm")),
    ("dcnv2", qe.gen_ctr, functools.partial(qe.ctr_trainer, "dcnv2")),
    ("xdeepfm", qe.gen_ctr, functools.partial(qe.ctr_trainer, "xdeepfm")),
    ("fignn", qe.gen_ctr, functools.partial(qe.ctr_trainer, "fignn")),
    ("eulernet", qe.gen_ctr, functools.partial(qe.ctr_trainer, "eulernet")),
    ("bpr", qe.gen_synth,
     lambda *a, **k: qe.matching_trainer("bpr", *a, **k)),
], ids=["deepfm_synthctr", "dcnv2_synthctr", "xdeepfm_synthctr",
         "fignn_synthctr", "eulernet_synthctr", "mf_bpr_synth"])
def test_paired_exit_starts_from_jax_weights(tmp_path, model, gen,
                                             port_trainer):
    seed = 2024
    data_dir = gen(str(tmp_path))
    jt, jl, jev = BUILDERS[model][1](data_dir, seed)
    dump(str(tmp_path), model, seed, jt, jl)
    want = jev(jt)
    pt, pl_, _ = port_trainer(data_dir, seed, "cpu",
                              init_from=str(tmp_path))
    pt.init(pl_.peek_batch())
    got = pt.eval_fn(pt)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    # an unpaired port run starts elsewhere
    up, upl, _ = port_trainer(data_dir, seed, "cpu")
    up.init(upl.peek_batch())
    assert any(abs(up.eval_fn(up)[k] - want[k]) > 1e-4 for k in want)


def test_dropout_free_pairing_follows_jax(tmp_path):
    """At dropout 0 nothing drawn is left apart: the port's DCNv2 exit
    run from JAX's initial weights (`quality_exit --dropout 0
    --init-from`) follows JAX's runner through three epochs, valid and
    test AUC / logloss within 1e-5 (the two packages' f32 sums in another
    order; at dropout 0.1 the two runs are 3e-4 to 2e-3 apart here)."""
    seed, epochs = 2024, 3
    data_dir = qe.gen_ctr(str(tmp_path))
    jt, jl, _ = BUILDERS["dcnv2"][1](data_dir, seed, dropout=0.0,
                                     epochs=epochs)
    dump(str(tmp_path), "dcnv2", seed, jt, jl)
    want = jax_ctr_fit(jt, jl, data_dir, seed)
    got = qe.run_ctr("dcnv2", data_dir, seed, "cpu", epochs=epochs,
                     init_from=str(tmp_path), dropout=0.0)
    assert (got["steps"], got["best_epoch"]) == (want["steps"],
                                                 want["best_epoch"])
    for split in ("valid", "test"):
        for k in ("AUC", "logloss"):
            np.testing.assert_allclose(got[split][k], want[split][k],
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{split} {k}")


def main(argv=None) -> int:
    import tempfile
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--models", nargs="+", default=list(BUILDERS),
                    choices=list(BUILDERS))
    ap.add_argument("--seeds", nargs="+", type=int,
                    default=[2024, 1, 2, 3, 4])
    ap.add_argument("--dataset", default="synth",
                    choices=list(qe.MATCHING_DATA))
    ap.add_argument("--dropout", type=float, default=None,
                    help="the synthctr runners' dropout (their 0.1 by "
                         "default)")
    ap.add_argument("--fit", action="store_true",
                    help="also train each synthctr runner (30 epochs) and "
                         "print its test metrics")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.models:
            gen, build = BUILDERS[name]
            tag = name
            if name in ("bpr", "lightgcn"):
                gen = qe.MATCHING_DATA[args.dataset]
                if args.dataset != "synth":
                    tag = f"{name}_{args.dataset}"
            data_dir = gen(tmp)
            ctr = name in qe.CTR_MODELS
            kw = {} if args.dropout is None or not ctr \
                else {"dropout": args.dropout}
            for seed in args.seeds:
                trainer, loader, _ = build(data_dir, seed, **kw)
                print(dump(args.out, tag, seed, trainer, loader), flush=True)
                if args.fit and ctr:
                    print(json.dumps({
                        "model": name, "seed": seed, "package": "jax",
                        "dropout": args.dropout,
                        **jax_ctr_fit(trainer, loader, data_dir, seed)}),
                        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
