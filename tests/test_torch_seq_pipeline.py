"""The port's sequential and matching pipelines against the JAX package's,
on the CPU.

- `_use_fused_ce` over a table of (model, compute dtype, vocabulary,
  flag) cases gives JAX's answer, and the port logs JAX's warning where a
  model that overrides its scoring asks for the kernel.
- The 'uni100' / 'pop100' candidates of `run_sequential_experiment` are
  JAX's arrays bit for bit (read back from JAX's run).
- `hit_positions` (the device-side rank of the 'full' protocol) equals
  the position of the target in JAX's `np.argsort(-scores)` on untied
  scores, and the stable sort's position over candidates.
- A paired `run_sequential_experiment` (SASRec, and GRU4Rec under
  'pop100') and `run_matching_experiment` (MF, sampled negatives; and
  SASRec under FullSoftmaxCE): the port starts from JAX's initial weights
  (`record_jax_inits` / `load_inits` of `tests/test_torch_reranking.py`),
  dropout 0, and every metric equals JAX's within 1e-4.
"""

import json
import logging

import numpy as np
import pytest
import torch

import recbox_tpu.quick_start as jqs
from recbox_tpu.data.sequential import leave_one_out_split as jloo
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.registry import get_model as jget_model
from recbox_tpu_torch import quick_start as qs
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.models.registry import get_model
from test_torch_reranking import load_inits, record_jax_inits

N_ITEMS, N_USERS, L = 40, 60, 8


def _fm(FM, FS, vocab=N_ITEMS + 1):
    return FM("seq", (FS("item_id", "categorical", source="item",
                         vocab_size=vocab, embedding_dim=16),),
              query_index="user_id", corpus_index="item_id", num_items=vocab)


def _splits(seed=3):
    """Leave-one-out splits of histories that mostly follow next = cur + 1
    (a Markov rule a model can learn), a tenth of the steps random."""
    rng = np.random.default_rng(seed)
    seqs = {}
    for u in range(N_USERS):
        n = rng.integers(5, 12)
        s = [int(rng.integers(1, N_ITEMS + 1))]
        for _ in range(n - 1):
            s.append(s[-1] % N_ITEMS + 1 if rng.random() < 0.9
                     else int(rng.integers(1, N_ITEMS + 1)))
        seqs[u] = np.asarray(s)
    return jloo(seqs, max_len=L)


# -- the fused-CE gate ----------------------------------------------------------------

GATE_MODELS = ("SASRec", "BERT4Rec", "GRU4Rec", "CORE", "RepeatNet")


@pytest.mark.parametrize("name", GATE_MODELS)
def test_use_fused_ce_matches_jax(name, caplog):
    kw = {"embedding_dim": 8, "max_seq_len": 4, "n_layers": 1,
          "hidden_size": 8}
    jcls, _ = jget_model(name)
    cls, _ = get_model(name)
    jfields = {f for f in jcls.__dataclass_fields__}
    for vocab in (1_000, 150_000):
        for dtype in ("float32", "bfloat16"):
            jm = jcls(feature_map=_fm(JFeatureMap, JFeatureSpec, vocab),
                      compute_dtype=dtype,
                      **{k: v for k, v in kw.items() if k in jfields})
            pm = qs.build_model({"model": name, "compute_dtype": dtype,
                                 **kw}, _fm(FeatureMap, FeatureSpec, vocab),
                                "cpu")[0]
            for flag in ({}, {"fused_ce": True}, {"fused_ce": False},
                         {"fused_ce_threshold": 500}):
                want = jqs._use_fused_ce(flag, jm.feature_map, jm, None)
                caplog.clear()
                with caplog.at_level(logging.WARNING):
                    got = qs._use_fused_ce(flag, pm.feature_map, pm)
                assert got == want, (vocab, dtype, flag)
                warned = any("fused_ce requested" in r.getMessage()
                             for r in caplog.records)
                assert warned == (name in ("CORE", "RepeatNet")
                                  and flag.get("fused_ce", False))
            assert not qs._use_fused_ce({"fused_ce": True}, pm.feature_map,
                                        pm, mesh=object())


# -- the protocols' candidates and the device ranking ---------------------------------

def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.mark.parametrize("protocol", ["uni100", "pop100"])
def test_candidates_equal_jax(monkeypatch, protocol):
    """The candidates JAX's run drew (its cache, read from the eval
    closure) equal the port's `_eval_candidates` bit for bit, for the
    valid and the test split."""
    train, valid, test = _splits()
    cfg = {"model": "SASRec", "embedding_dim": 16, "max_seq_len": L,
           "n_layers": 1, "dropout": 0.0, "epochs": 1, "batch_size": 32,
           "eval_protocol": protocol, "exclude_items": [3], "seed": 11,
           "monitor": "NDCG(k=10)"}
    seen = []
    orig = jqs.Trainer.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        seen.append(self)

    monkeypatch.setattr(jqs.Trainer, "__init__", init)
    jqs.run_sequential_experiment(cfg, _fm(JFeatureMap, JFeatureSpec),
                                  train, valid, test_arrays=test)
    eval_split = _closure(seen[0].eval_fn, "eval_split")
    cache = _closure(_closure(eval_split, "_candidates"), "_cand_cache")
    fm = _fm(FeatureMap, FeatureSpec)
    for split_id, split in ((0, valid), (1, test)):
        got = qs._eval_candidates(protocol, split, fm, train["item_id"], cfg)
        assert got.dtype == cache[split_id].dtype
        np.testing.assert_array_equal(got, cache[split_id])
        assert (got[:, 0] == split["item_id"]).all()


def test_device_ranking_equals_argsort_positions():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(64, 500)).astype(np.float32)
    tgt = rng.integers(0, 500, 64)
    order = np.argsort(-scores, axis=1)
    want = np.argmax(order == tgt[:, None], axis=1)
    got = qs.hit_positions(torch.from_numpy(scores), torch.from_numpy(tgt))
    np.testing.assert_array_equal(got.numpy(), want)
    # ties: the equal items before the target in index order come first
    tied = np.zeros((2, 6), np.float32)
    tied[1, 5] = 1.0
    got = qs.hit_positions(torch.from_numpy(tied), torch.tensor([3, 2]))
    np.testing.assert_array_equal(got.numpy(), [3, 3])
    # candidates: the stable sort's position of column 0
    cand = np.stack([tgt, *(rng.integers(0, 500, (20, 64)))], axis=1)
    cs = np.take_along_axis(scores, cand, axis=1)
    order = np.take_along_axis(cand, np.argsort(-cs, axis=1, kind="stable"),
                               axis=1)
    want = np.argmax(order == tgt[:, None], axis=1)
    got = qs.hit_positions(torch.from_numpy(scores), torch.from_numpy(tgt),
                           torch.from_numpy(cand))
    np.testing.assert_array_equal(got.numpy(), want)
    m = qs.rank_metrics(np.array([0, 3, 9, 10]), (1, 10))
    assert m["Recall(k=1)"] == 0.25 and m["Recall(k=10)"] == 0.75
    np.testing.assert_allclose(m["NDCG(k=10)"], (1 + 1 / np.log2(5)
                                                 + 1 / np.log2(11)) / 4)


# -- paired pipelines ------------------------------------------------------------------

def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("model,extra", [
    ("SASRec", {"n_layers": 1, "n_heads": 2}),
    ("GRU4Rec", {"hidden_size": 16, "eval_protocol": "pop100"}),
])
def test_run_sequential_experiment_paired_with_jax(monkeypatch, model,
                                                   extra):
    train, valid, test = _splits()
    cfg = {"model": model, "embedding_dim": 16, "max_seq_len": L,
           "dropout": 0.0, "epochs": 3, "batch_size": 16,
           "learning_rate": 1e-2, "eval_batch_size": 24,
           "monitor": "NDCG(k=10)", "seed": 5, **extra}
    with record_jax_inits(monkeypatch) as inits:
        want = jqs.run_sequential_experiment(
            cfg, _fm(JFeatureMap, JFeatureSpec), train, valid,
            test_arrays=test, ks=(5, 10))
    load_inits(monkeypatch, inits)
    got = qs.run_sequential_experiment(cfg, _fm(FeatureMap, FeatureSpec),
                                       train, valid, test_arrays=test,
                                       ks=(5, 10), device="cpu")
    _assert_metrics_equal(got, want)
    assert got["test_Recall(k=10)"] > 10 / N_ITEMS


def _matching_inputs():
    rng = np.random.default_rng(4)
    users = np.repeat(np.arange(30), 8)
    items = (users % 6) * 5 + rng.integers(1, 6, len(users))
    fm = {"J": JFeatureMap("mf", (
        JFeatureSpec("user_id", "categorical", source="user",
                     vocab_size=30, embedding_dim=8),
        JFeatureSpec("item_id", "categorical", source="item",
                     vocab_size=31, embedding_dim=8)),
        query_index="user_id", corpus_index="item_id", num_items=31)}
    fm["P"] = FeatureMap.from_dict(json.loads(fm["J"].to_json()))
    u2i = [{}, {}, {}]            # a user's 8 rows: 6 train, valid, test
    for r, (u, i) in enumerate(zip(users, items)):
        part = 0 if r % 8 < 6 else r % 8 - 5
        u2i[part].setdefault(int(u), []).append(int(i))
    tr = np.array([(u, i) for u, its in u2i[0].items() for i in its])
    vu = np.asarray(sorted(u2i[1]), np.int64)
    return fm, ({"user_id": tr[:, 0].astype(np.int32),
                 "item_id": tr[:, 1].astype(np.int32)},
                {"item_id": np.arange(31, dtype=np.int32)},
                {"user_id": vu.astype(np.int32)}, vu, u2i[0], u2i[1]), u2i[2]


def test_run_matching_experiment_paired_with_jax(monkeypatch):
    """MF under sampled negatives (`MatchingLoader`, bit for bit with
    JAX's), full-sort valid, a test phase with train ∪ valid masked, and
    beyond-accuracy keys passed through to both evaluators."""
    fm, args, test_u2i = _matching_inputs()
    cfg = {"model": "MF", "embedding_dim": 8, "epochs": 3, "batch_size": 32,
           "learning_rate": 5e-2, "num_negs": 3, "seed": 2,
           "monitor": "Recall(k=5)",
           "metrics": ["Recall(k=5)", "NDCG(k=5)"],
           "beyond_accuracy_metrics": ["ItemCoverage", "GiniIndex"],
           "beyond_topk": 5, "exclude_items": [0]}
    with record_jax_inits(monkeypatch) as inits:
        want = jqs.run_matching_experiment(cfg, fm["J"], *args,
                                           test_user2items=test_u2i)
    load_inits(monkeypatch, inits)
    got = qs.run_matching_experiment(cfg, fm["P"], *args,
                                     test_user2items=test_u2i,
                                     device="cpu")
    assert "test_ItemCoverage" in got
    _assert_metrics_equal(got, want)
    assert got["test_Recall(k=5)"] > 5 / 30


def test_run_matching_full_softmax_route_paired_with_jax(monkeypatch):
    """A sequential model under ``loss: FullSoftmaxCE`` in the matching
    pipeline (the logits route below the kernel's threshold), 'uni20'
    valid evaluation over the items."""
    train, valid, _ = _splits()
    cfg = {"model": "SASRec", "loss": "FullSoftmaxCE", "embedding_dim": 16,
           "max_seq_len": L, "n_layers": 1, "dropout": 0.0, "epochs": 2,
           "batch_size": 16, "learning_rate": 1e-2, "seed": 9,
           "monitor": "Recall(k=10)", "metrics": ["Recall(k=10)"],
           "eval_protocol": "uni20"}
    users = valid["user_id"].astype(np.int64)
    u2i_train = {int(u): [int(i) for i in s[s > 0]]
                 for u, s in zip(train["user_id"], train["item_seq"])}
    u2i_valid = {int(u): [int(i)] for u, i in zip(users, valid["item_id"])}
    user_arrays = {k: valid[k] for k in ("user_id", "item_seq", "seq_len")}
    args = (train, {"item_id": np.arange(N_ITEMS + 1, dtype=np.int32)},
            user_arrays, users, u2i_train, u2i_valid)
    with record_jax_inits(monkeypatch) as inits:
        want = jqs.run_matching_experiment(
            cfg, _fm(JFeatureMap, JFeatureSpec), *args)
    load_inits(monkeypatch, inits)
    got = qs.run_matching_experiment(cfg, _fm(FeatureMap, FeatureSpec),
                                     *args, device="cpu")
    _assert_metrics_equal(got, want)
    assert got["Recall(k=10)"] > 10 / 21
