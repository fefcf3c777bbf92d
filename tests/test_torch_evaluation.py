"""The port's evaluation against the JAX package's, on the CPU.

- `evaluate_ctr`, every metric, on predictions with ties and groups with a
  single class: the host metrics (AUC, logloss, ACC, MAE, RMSE) to rtol
  1e-12 (the same numpy code), the grouped ones (gAUC, avgAUC, MRR,
  NDCG@k) to 1e-6 (both engines sort and sum in float32, in their own
  order); the port's device engine against its own host loop likewise;
  the NDCG@k spellings and a k that does not parse.
- `auc_torch` against `auc_jax` within 1e-6 (one histogram, float32 sums).
- `evaluate_retrieval` against JAX's on random embeddings with train-item
  masks (repeats included), ``exclude_items``, duplicate valid ids, a
  (U, K, D) multi-interest case and a forced small chunk, every metric at
  two cutoffs, within 1e-6 (f32 scores; the per-user values are sums of a
  few terms); `retrieval_metrics_from_topk`, `full_sort_topk` and
  `std_gauc` likewise (`std_gauc` to 1e-12, numpy on both sides).
- `CTREvaluator` and `RetrievalEvaluator` on a trainer against JAX's on the
  same params (transplanted through `interop`) within 1e-6; the sampled
  protocols and beyond-accuracy metrics raise NotImplementedError.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.evaluation import CTREvaluator as JCTREvaluator
from recbox_tpu.evaluation import RetrievalEvaluator as JRetrievalEvaluator
from recbox_tpu.evaluation import ctr as jctr
from recbox_tpu.evaluation import retrieval as jret
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.matching import two_tower as jtt
from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.evaluation import (
    CTREvaluator, RetrievalEvaluator, auc_torch, evaluate_ctr,
    evaluate_retrieval, full_sort_topk, grouped_auc,
    retrieval_metrics_from_topk, std_gauc,
)
from recbox_tpu_torch.evaluation import ctr as pctr
from recbox_tpu_torch.evaluation.grouped import grouped_metrics_device
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.matching import two_tower as ptt
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.training import Trainer, TrainerConfig

HOST = ["AUC", "logloss", "ACC", "MAE", "RMSE"]
GROUPED = ["gAUC", "avgAUC", "MRR", "NDCG@3", "NDCG(k=5)", "NDCG"]


def _ctr_data(seed, n=600, groups=40):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.6).astype(np.float32)
    p = np.round(rng.random(n), 1).astype(np.float32)      # many ties
    g = rng.integers(0, groups, n)
    g[:20] = groups                      # a group of one class only
    y[:20] = 1.0
    return y, p, g


# -- CTR -----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_ctr_matches_jax(seed):
    y, p, g = _ctr_data(seed)
    jout = jctr.evaluate_ctr(y, p, HOST + GROUPED, group_id=g)
    pout = evaluate_ctr(y, p, HOST + GROUPED, group_id=g, device="cpu")
    assert list(pout) == list(jout)
    for m in HOST:
        np.testing.assert_allclose(pout[m], jout[m], rtol=1e-12, err_msg=m)
    for m in GROUPED:
        np.testing.assert_allclose(pout[m], jout[m], rtol=1e-6, err_msg=m)


@pytest.mark.parametrize("seed", [3, 4])
def test_grouped_device_engine_matches_host_loop(seed):
    """The one-pass engine against the host loop it replaces, and the host
    loop against JAX's host loop exactly."""
    y, p, g = _ctr_data(seed)
    dev = grouped_metrics_device(y, p, g, ["gAUC", "avgAUC", "MRR"],
                                 ndcg_ks=(3, 10), device="cpu")
    host = {"gAUC": grouped_auc(y, p, g),
            "avgAUC": grouped_auc(y, p, g, weighted=False),
            "MRR": pctr._grouped_rank_metric(y, p, g, pctr._mrr),
            "NDCG@3": pctr._grouped_rank_metric(
                y, p, g, lambda t, q: pctr._ndcg(t, q, 3)),
            "NDCG@10": pctr._grouped_rank_metric(
                y, p, g, lambda t, q: pctr._ndcg(t, q, 10))}
    for k, v in host.items():
        np.testing.assert_allclose(dev[k], v, rtol=1e-6, err_msg=k)
    assert host["gAUC"] == jctr.grouped_auc(y, p, g)
    assert host["MRR"] == jctr._grouped_rank_metric(y, p, g, jctr._mrr)


def test_evaluate_ctr_errors_match_jax():
    y, p, g = _ctr_data(5)
    for bad in ("NDCG_x", "NDCG@"):
        with pytest.raises(ValueError, match="cannot parse k"):
            jctr.evaluate_ctr(y, p, [bad], group_id=g)
        with pytest.raises(ValueError, match="cannot parse k"):
            evaluate_ctr(y, p, [bad], group_id=g, device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        evaluate_ctr(y, p, ["F2"], device="cpu")
    with pytest.raises(ValueError, match="group_index"):
        evaluate_ctr(y, p, ["gAUC"], device="cpu")
    with pytest.raises(ValueError, match="unknown grouped metric"):
        grouped_metrics_device(y, p, g, ["gauc"], device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_auc_torch_matches_auc_jax(seed):
    rng = np.random.default_rng(seed)
    labels = (rng.random(5000) > 0.7).astype(np.float32)
    probs = np.clip(0.3 * labels + 0.7 * rng.random(5000), 0, 1).astype(
        np.float32)
    probs[:10] = 1.0                   # the top bucket's edge
    want = float(jctr.auc_jax(jnp.asarray(probs), jnp.asarray(labels)))
    got = float(auc_torch(torch.from_numpy(probs), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs(got - pctr.auc_score(labels, probs)) < 2e-3


# -- retrieval -------------------------------------------------------------------

METRICS = [f"{m}(k={k})" for k in (5, 12) for m in (
    "Recall", "nRecall", "Precision", "F1", "DCG", "NDCG", "MRR", "StdMRR",
    "HitRate", "MAP", "StdMAP")]


def _retrieval_case(seed, multi=False, n_users=37, n_items=120, d=8):
    rng = np.random.default_rng(seed)
    shape = (n_users, 3, d) if multi else (n_users, d)
    users = rng.normal(size=shape).astype(np.float32)
    items = rng.normal(size=(n_items, d)).astype(np.float32)
    query = rng.permutation(200)[:n_users]
    train = {int(q): list(rng.integers(0, n_items, rng.integers(0, 30)))
             for q in query[::2]}
    train[int(query[0])] += train[int(query[0])][:3]      # repeats
    valid = {int(q): list(rng.integers(0, n_items, rng.integers(1, 6)))
             for q in query[1:]}
    valid[int(query[1])] = [4, 4, 4, 9]                    # duplicates
    return users, items, train, valid, query


@pytest.mark.parametrize("multi,chunk", [(False, 1024), (False, 7),
                                         (True, 1024), (True, 5)])
def test_evaluate_retrieval_matches_jax(multi, chunk):
    users, items, train, valid, query = _retrieval_case(int(multi) + chunk,
                                                        multi)
    kw = dict(metrics=METRICS, chunk_size=chunk, exclude_items=(0, 17))
    want = jret.evaluate_retrieval(users, items, train, valid, query, **kw)
    got = evaluate_retrieval(users, items, train, valid, query,
                             device="cpu", **kw)
    assert list(got) == list(want)
    for m in METRICS:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-6, atol=1e-7,
                                   err_msg=m)


def test_topk_helpers_and_std_gauc_match_jax():
    rng = np.random.default_rng(11)
    topk = rng.integers(0, 50, (20, 12))
    true = rng.integers(-1, 50, (20, 4))
    want = jret.retrieval_metrics_from_topk(topk, true, METRICS)
    got = retrieval_metrics_from_topk(topk, true, METRICS, device="cpu")
    for m in METRICS:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-6, err_msg=m)
    users, items, *_ = _retrieval_case(12)
    mask = np.full((len(users), 3), items.shape[0])
    mask[:, 0] = rng.integers(0, items.shape[0], len(users))
    js, ji = jret.full_sort_topk(users, items, 9, train_items=mask)
    ps, pi = full_sort_topk(users, items, 9, train_items=mask, device="cpu")
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_allclose(ps, np.asarray(js), rtol=1e-6)
    scores = rng.normal(size=(15, 30))
    scores[rng.random(scores.shape) < 0.2] = -np.inf
    pos = (rng.random((15, 30)) < 0.2) & np.isfinite(scores)
    pos[0] = False                                      # no positive
    np.testing.assert_allclose(std_gauc(scores, pos),
                               jret.std_gauc(scores, pos), rtol=1e-12)


# -- the evaluators on a trainer ------------------------------------------------

def test_ctr_evaluator_on_a_trainer_matches_jax():
    specs = [("c0", 30), ("c1", 20)]
    jfm = JFeatureMap("t", tuple(JFeatureSpec(n, "categorical", vocab_size=v,
                                              embedding_dim=8)
                                 for n, v in specs), labels=("y",))
    pfm = FeatureMap("t", tuple(FeatureSpec(n, "categorical", vocab_size=v,
                                            embedding_dim=8)
                                for n, v in specs), labels=("y",))
    rng = np.random.default_rng(13)
    n = 700                                     # a padded tail batch
    arrays = {"c0": rng.integers(0, 30, n).astype(np.int32),
              "c1": rng.integers(0, 20, n).astype(np.int32),
              "y": (rng.random(n) > 0.5).astype(np.float32),
              "g": rng.integers(0, 25, n)}
    jt = JTrainer(JDeepFM(feature_map=jfm, embedding_dim=8,
                          hidden_units=(16,)), None, JTrainerConfig())
    jt.init({k: v[:8] for k, v in arrays.items()})
    pm = DeepFM(pfm, embedding_dim=8, hidden_units=(16,), device="cpu")
    pm.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, fnn.meta.unbox(jt.params)), pm))
    pt = Trainer(pm, None, TrainerConfig(), device="cpu")
    pt.init({})
    metrics = ["AUC", "logloss", "gAUC", "NDCG@5"]
    want = JCTREvaluator(arrays, "y", metrics, group_id="g",
                         batch_size=256)(jt)
    got = CTREvaluator(arrays, "y", metrics, group_id="g",
                       batch_size=256)(pt)
    for m in metrics:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-6, err_msg=m)


def test_retrieval_evaluator_on_a_trainer_matches_jax():
    n_users, n_items, d = 60, 90, 16
    mk = (lambda S: (S("user_id", "categorical", source="user",
                       vocab_size=n_users, embedding_dim=d),
                     S("item_id", "categorical", source="item",
                       vocab_size=n_items, embedding_dim=d)))
    jfm = JFeatureMap("t", mk(JFeatureSpec), query_index="user_id",
                      corpus_index="item_id", num_items=n_items)
    pfm = FeatureMap("t", mk(FeatureSpec), query_index="user_id",
                     corpus_index="item_id", num_items=n_items)
    jm = jtt.MF(feature_map=jfm, embedding_dim=d)
    users = {"user_id": np.arange(n_users, dtype=np.int32)}
    corpus = {"item_id": np.arange(n_items, dtype=np.int32)}
    vu = jm.init(jax.random.PRNGKey(0), users, method=jm.encode_user)
    vi = jm.init(jax.random.PRNGKey(1), corpus, method=jm.encode_item)
    params = jax.tree_util.tree_map(np.asarray, {
        **fnn.meta.unbox(vu["params"]), **fnn.meta.unbox(vi["params"])})
    jt = JTrainer(jm, None, JTrainerConfig())
    jt.params, jt.model_state = params, {}
    pm = ptt.MF(pfm, embedding_dim=d, device="cpu")
    pm.load_state_dict(from_jax_params(params, pm))
    pt = Trainer(pm, None, TrainerConfig(), device="cpu")
    pt.init({})
    rng = np.random.default_rng(14)
    train = {u: list(rng.integers(0, n_items, 5)) for u in range(n_users)}
    valid = {u: list(rng.integers(0, n_items, 3)) for u in range(n_users)}
    kw = dict(metrics=["Recall(k=10)", "NDCG(k=10)", "HitRate(k=5)"],
              batch_size=32, exclude_items=(3,))
    want = JRetrievalEvaluator(users, corpus, np.arange(n_users), train,
                               valid, **kw)(jt)
    got = RetrievalEvaluator(users, corpus, np.arange(n_users), train,
                             valid, **kw)(pt)
    for m in kw["metrics"]:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-6, err_msg=m)
    with pytest.raises(NotImplementedError, match="candidate.py"):
        RetrievalEvaluator(users, corpus, [0], train, valid,
                           protocol="uni100")
    with pytest.raises(NotImplementedError, match="beyond_accuracy"):
        RetrievalEvaluator(users, corpus, [0], train, valid,
                           beyond_accuracy_metrics=["GiniIndex"])


def test_multitask_evaluator_matches_jax():
    """Per-task metrics and their mean from one (N, T) prediction, against
    JAX's on the same logits (a trainer stand-in that returns them)."""
    from recbox_tpu.evaluation.evaluators import (
        MultiTaskEvaluator as JMultiTaskEvaluator,
    )
    from recbox_tpu_torch.evaluation import MultiTaskEvaluator

    rng = np.random.default_rng(15)
    logits = rng.normal(size=(300, 2)).astype(np.float32)
    arrays = {"a": (rng.random(300) > 0.5).astype(np.float32),
              "b": (logits[:, 1] + rng.normal(size=300) > 0).astype(
                  np.float32)}

    class Stub:
        device = torch.device("cpu")

        def predict(self, loader):
            return logits

    want = JMultiTaskEvaluator(arrays, ["a", "b"])(Stub())
    got = MultiTaskEvaluator(arrays, ["a", "b"])(Stub())
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
