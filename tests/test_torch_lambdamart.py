"""The port's LambdaMART against the JAX package's, bit for bit, on the
CPU.

Both are numpy float64 host code (the port's a copy): the same queries
(graded relevance, ties in the scores, one query of a single document and
one of equal relevance) give the same lambdas, the same trees node by
node, the same predictions and the same NDCG@k, compared with ``==``.
"""

import dataclasses

import numpy as np
import pytest

from recbox_tpu.models.reranking import lambdamart as J
from recbox_tpu_torch.models.reranking import lambdamart as P


def _queries(seed, n_q=12, n_feat=5):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, 15, n_q)
    sizes[0], sizes[1] = 1, 6
    qid = np.repeat(np.arange(n_q), sizes)
    X = rng.normal(size=(len(qid), n_feat))
    rel = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1]
                           + 0.3 * rng.normal(size=len(qid)) + 1), 0, 3)
    rel[qid == 1] = 2.0                     # a query of equal relevance
    return X, rel, qid


@pytest.mark.parametrize("seed", [0, 1])
def test_lambdas_for_query_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 7, 20):
        rel = rng.integers(0, 4, n).astype(np.float64)
        scores = np.round(rng.normal(size=n), 1)          # ties
        for sigma in (1.0, 0.5):
            got = P._lambdas_for_query(scores, rel, sigma)
            want = J._lambdas_for_query(scores, rel, sigma)
            assert np.array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(n_trees=6, max_depth=3),
                                dict(n_trees=4, learning_rate=0.3,
                                     max_depth=2, min_samples_leaf=4)])
def test_trees_predictions_and_ndcg_bit_for_bit(kw):
    X, rel, qid = _queries(2)
    jm = J.LambdaMART(**kw).fit(X, rel, qid)
    pm = P.LambdaMART(**kw).fit(X, rel, qid)
    assert len(pm.trees) == len(jm.trees) == kw["n_trees"]
    for pt, jt in zip(pm.trees, jm.trees):
        assert [dataclasses.astuple(n) for n in pt.nodes] == \
            [dataclasses.astuple(n) for n in jt.nodes]
    Xt, relt, qidt = _queries(3)
    assert np.array_equal(pm.predict(Xt), jm.predict(Xt))
    for k in (3, 10):
        assert pm.ndcg(Xt, relt, qidt, k=k) == jm.ndcg(Xt, relt, qidt, k=k)
    assert pm.ndcg(Xt, relt, qidt) > 0.5
