"""Sampled-protocol and beyond-accuracy evaluation of the port against the
JAX package, on the CPU.

- `parse_protocol`'s spellings and errors.
- `sample_eval_candidates` bit for bit (dtypes included) with JAX's for
  'uni100' and 'pop100' (and 'pop5' from all-zero counts), with
  ``exclude_items``, with users dense enough that ``max_attempts`` gives
  up (their collisions stay), with ``user_chunk``, and with duplicate and
  missing positives.
- `candidate_topk`'s ids equal JAX's, ties (repeated ids, masked slots)
  position ascending.
- `evaluate_candidate_retrieval` (also multi-interest users) and each
  beyond-accuracy metric against JAX's within 1e-6 (absolute; the metrics
  are means of counts, ranks and logs). Scores are drawn without ties.
- `RetrievalEvaluator` with 'uni20' / 'pop20' and with the full sort, each
  with every beyond-accuracy metric, on an MF transplanted from the JAX
  model, against JAX's evaluator within 1e-6; two calls reuse one
  candidate matrix.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.evaluation import beyond_accuracy as jba
from recbox_tpu.evaluation import candidate as jcand
from recbox_tpu.evaluation import RetrievalEvaluator as JRetrievalEvaluator
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.matching.two_tower import MF as JMF
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.evaluation import beyond_accuracy as pba
from recbox_tpu_torch.evaluation import candidate as pcand
from recbox_tpu_torch.evaluation import RetrievalEvaluator
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.matching import MF
from recbox_tpu_torch.training import Trainer, TrainerConfig

N_USERS, N_ITEMS, DIM = 40, 300, 8


def _u2i(seed=0, dense=()):
    rng = np.random.default_rng(seed)
    train, valid = {}, {}
    for u in range(N_USERS):
        train[u] = rng.choice(N_ITEMS, rng.integers(1, 12),
                              replace=False).tolist()
        valid[u] = rng.integers(0, N_ITEMS, rng.integers(0, 5)).tolist()
    valid[0] = valid[0] + valid[0][:1] if valid[0] else [3, 3]  # repeats
    for u in dense:                        # nearly the whole catalog seen
        train[u] = list(range(N_ITEMS - 2))
    return train, valid


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_parse_protocol():
    for p in ("uni100", "pop5", "uni1"):
        assert pcand.parse_protocol(p) == jcand.parse_protocol(p)
    for bad in ("full", "uni", "Uni100", "pop-1", "rand100", "uni100 "):
        with pytest.raises(NotImplementedError):
            pcand.parse_protocol(bad)


CAND_CASES = {
    "uni100": dict(num_negs=100),
    "pop100": dict(num_negs=100, distribution="popularity"),
    "pop5_zero_counts": dict(num_negs=5, distribution="popularity",
                             zero_counts=True),
    "exclude": dict(num_negs=20, exclude_items=(0, 1, 2, N_ITEMS + 3)),
    "gives_up": dict(num_negs=30, dense=(4, 7), max_attempts=3),
    "user_chunk": dict(num_negs=10, user_chunk=7,
                       distribution="popularity"),
}


@pytest.mark.parametrize("case", list(CAND_CASES), ids=list(CAND_CASES))
def test_sample_eval_candidates_bit_for_bit(case):
    kw = dict(CAND_CASES[case])
    train, valid = _u2i(1, dense=kw.pop("dense", ()))
    q = np.arange(N_USERS)
    q[5] = N_USERS + 9                     # a user with no lists at all
    counts = np.bincount(np.concatenate([np.asarray(v) for v in
                                         train.values()]),
                         minlength=N_ITEMS)
    if kw.pop("zero_counts", False):
        counts = np.zeros(N_ITEMS)
    if kw.get("distribution") == "popularity":
        kw["item_counts"] = counts
    a = jcand.sample_eval_candidates(q, train, valid, N_ITEMS, seed=9, **kw)
    b = pcand.sample_eval_candidates(q, train, valid, N_ITEMS, seed=9, **kw)
    _equal(a, b)
    cand, valid_m, true = b
    if case == "gives_up":
        seen = set(train[4])
        assert any(c in seen for c, ok in zip(cand[4], valid_m[4])
                   if ok and c < N_ITEMS)
    if case == "exclude":
        assert not np.isin(cand[valid_m], [0, 1, 2]).any() or \
            np.isin(true, [0, 1, 2]).any()


def _embs(seed, n_users=N_USERS, multi=False):
    rng = np.random.default_rng(seed)
    shape = (n_users, 3, DIM) if multi else (n_users, DIM)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=(N_ITEMS, DIM)).astype(np.float32))


@pytest.mark.parametrize("multi", [False, True])
def test_evaluate_candidate_retrieval(multi):
    train, valid = _u2i(2)
    q = np.arange(N_USERS)
    cands = pcand.sample_eval_candidates(q, train, valid, N_ITEMS, 50,
                                         seed=3)
    u, it = _embs(4, multi=multi)
    metrics = ["Recall(k=10)", "NDCG(k=10)", "MRR(k=5)", "HitRate(k=20)",
               "Precision(k=3)"]
    want = jcand.evaluate_candidate_retrieval(u, it, *cands, metrics,
                                              chunk_size=16)
    got = pcand.evaluate_candidate_retrieval(u, it, *cands, metrics,
                                             chunk_size=16, device="cpu")
    assert list(got) == list(want)
    for m in metrics:
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-6,
                                   err_msg=m)
    jt = np.asarray(jcand.candidate_topk(jnp.asarray(u), jnp.asarray(it),
                                         jnp.asarray(cands[0]),
                                         jnp.asarray(cands[1]), 7))
    pt = pcand.candidate_topk(torch.from_numpy(u), torch.from_numpy(it),
                              torch.from_numpy(cands[0]),
                              torch.from_numpy(cands[1]), 7).numpy()
    np.testing.assert_array_equal(pt, jt)


BEYOND = ["ItemCoverage", "AveragePopularity", "ShannonEntropy",
          "GiniIndex", "TailPercentage", "Diversity"]


@pytest.mark.parametrize("padded", [False, True])
def test_beyond_accuracy_metrics(padded):
    rng = np.random.default_rng(6)
    topk = rng.zipf(1.3, (50, 10)) % N_ITEMS
    if padded:
        topk[:5, 6:] = N_ITEMS             # pad slots, dropped
    counts = rng.integers(0, 30, N_ITEMS)
    counts[:20] = 0
    cats = (rng.random((N_ITEMS, 6)) < 0.3).astype(np.float32)
    want = jba.evaluate_beyond_accuracy(topk, N_ITEMS, item_counts=counts,
                                        metrics=BEYOND, tail_ratio=0.2,
                                        item_categories=cats)
    got = pba.evaluate_beyond_accuracy(topk, N_ITEMS, item_counts=counts,
                                       metrics=BEYOND, tail_ratio=0.2,
                                       item_categories=cats)
    assert list(got) == list(want)
    for m in BEYOND:
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-6,
                                   err_msg=m)
    with pytest.raises(NotImplementedError):
        pba.evaluate_beyond_accuracy(topk, N_ITEMS, metrics=["Novelty"])
    with pytest.raises(ValueError):
        pba.evaluate_beyond_accuracy(topk, N_ITEMS,
                                     metrics=["AveragePopularity"])


def _mf_pair():
    specs = [("user_id", "user", N_USERS), ("item_id", "item", N_ITEMS)]
    kw = dict(query_index="user_id", corpus_index="item_id",
              num_items=N_ITEMS)
    jfm = JFeatureMap("c", tuple(JFeatureSpec(n, "categorical", s,
                                              vocab_size=v,
                                              embedding_dim=DIM)
                                 for n, s, v in specs), **kw)
    pfm = FeatureMap("c", tuple(FeatureSpec(n, "categorical", s,
                                            vocab_size=v, embedding_dim=DIM)
                                for n, s, v in specs), **kw)
    jt = JTrainer(JMF(feature_map=jfm, embedding_dim=DIM,
                      emb_init_scheme="xavier_normal"),
                  lambda o, b: jnp.mean(o), JTrainerConfig())
    batch = {"user_id": np.zeros(4, np.int32),
             "item_id": np.zeros(4, np.int32),
             "__item_ids__": np.zeros((4, 2), np.int32),
             "item::item_id": np.zeros((4, 2), np.int32)}
    jt.init(batch)
    pm = MF(pfm, embedding_dim=DIM, device="cpu")
    pm.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, fnn.meta.unbox(jt.params)), pm))
    pt = Trainer(pm, lambda o, b: o.mean(), TrainerConfig(), device="cpu")
    pt.init(batch)
    return jt, pt


@pytest.mark.parametrize("protocol", ["uni20", "pop20", "full"])
def test_retrieval_evaluator_matches_jax(protocol):
    jt, pt = _mf_pair()
    train, valid = _u2i(3)
    q = np.array(sorted(valid), np.int32)
    users = {"user_id": q}
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    metrics = ["Recall(k=10)", "NDCG(k=10)"]
    kw = dict(metrics=metrics, batch_size=16, protocol=protocol,
              protocol_seed=5, beyond_accuracy_metrics=BEYOND[:5],
              beyond_topk=10, exclude_items=(0,))
    jev = JRetrievalEvaluator(users, corpus, q, train, valid, **kw)
    pev = RetrievalEvaluator(users, corpus, q, train, valid, **kw)
    want, got = jev(jt), pev(pt)
    assert list(got) == list(want)
    for m in want:
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-6,
                                   err_msg=m)
    if protocol != "full":
        first = pev._candidates
        _equal(first, jev._candidates)
        pev(pt)
        assert pev._candidates is first
    with pytest.raises(NotImplementedError):
        RetrievalEvaluator(users, corpus, q, train, valid, protocol="neg20")
