"""The port's listwise rerank metrics and list builder against the JAX
package's, on the CPU.

`evaluate_rerank` (MAP@k, NDCG@k with exponential gain, clicks@k) and
`build_rerank_lists` are numpy in both packages; the port keeps its own
copy. The same inputs give the same floats exactly: masked and ragged
lists, k past the list length, graded labels, propensities (labels
divided by them, clipped at 1e-6), propensities small enough to push the
gain's exponent past its cap of 500 (no inf / NaN), lists without a
relevant slot, and lists grouped from rows by query (ordered by an
upstream score or as given, truncated and padded).
"""

import numpy as np
import pytest

from recbox_tpu.evaluation.rerank import build_rerank_lists as jbuild
from recbox_tpu.evaluation.rerank import evaluate_rerank as jeval
from recbox_tpu_torch.evaluation.rerank import (
    build_rerank_lists, evaluate_rerank,
)


def _case(seed, b=40, n=12, graded=False):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, n))
    scores[:, 3] = scores[:, 2]                    # ties, stable order
    labels = (rng.integers(0, 3, (b, n)) if graded
              else (rng.random((b, n)) < 0.3)).astype(np.float32)
    labels[0] = 0.0                                # a list with no click
    mask = np.arange(n)[None] < rng.integers(1, n + 1, b)[:, None]
    return scores, labels, mask


@pytest.mark.parametrize("kw", [
    dict(), dict(graded=True), dict(with_mask=True),
    dict(with_mask=True, graded=True, ks=(1, 5, 20)),
    dict(props="moderate"), dict(props="tiny", with_mask=True),
], ids=["plain", "graded", "masked", "masked-graded-k-past-n",
        "propensities", "exponent-cap"])
def test_evaluate_rerank_equals_jax(kw):
    kw = dict(kw)
    scores, labels, mask = _case(0, graded=kw.pop("graded", False))
    args = dict(ks=kw.pop("ks", (5, 10)))
    if kw.pop("with_mask", False):
        args["mask"] = mask
    props = kw.pop("props", None)
    if props == "moderate":
        args["props"] = 1.0 / (1.0 + np.arange(scores.shape[1]))[None] \
            .repeat(len(scores), 0)
    elif props == "tiny":
        # labels / 1e-6 reach 2e6: 2^label overflows without the cap
        args["props"] = np.full(scores.shape, 1e-9)
    want = jeval(scores, labels, **args)
    got = evaluate_rerank(scores, labels, **args)
    assert list(got) == list(want)
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("use_scores", [False, True])
def test_build_rerank_lists_equals_jax(use_scores):
    rng = np.random.default_rng(5)
    rows = 200
    qids = rng.integers(0, 30, rows) * 7 + 3        # sparse query ids
    feats = rng.normal(size=(rows, 4)).astype(np.float32)
    labels = (rng.random(rows) < 0.3).astype(np.float32)
    scores = rng.normal(size=rows) if use_scores else None
    want = jbuild(qids, feats, labels, list_size=6, scores=scores)
    got = build_rerank_lists(qids, feats, labels, list_size=6,
                             scores=scores)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["mask"].sum() < got["mask"].size     # padded lists exist
