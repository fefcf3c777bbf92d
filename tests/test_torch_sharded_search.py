"""The port's mesh-sharded MIPS search against the JAX package's.

Mirrors the mesh cases of `tests/test_retrieval_index.py` (:46-107, :417)
on four gloo ranks (`torch_parallel_workers.sharded_search`): exact
against a numpy oracle, a corpus that does not divide into the shards
(padding rows never returned), the 'approx' route of a shard, the int8
index's refusal of a mesh; and each case against JAX's `shard_map` search
over the same mesh shape (``make_mesh(num_model_shards=m,
devices=jax.devices()[:4])``). The JAX comparisons run on integer-valued
rows and queries, whose dot products are exact in f32 in any order, so
both packages see the same scores: the ids agree but for ties at the k-th
score, and the scores within 1e-6.
"""

import jax
import numpy as np
import pytest

import torch_parallel_workers as W
from recbox_tpu.parallel import make_mesh as jmake_mesh
from recbox_tpu.retrieval import BruteForceMIPS as JMIPS
from test_torch_retrieval import _sets_equal_but_ties

# name: (corpus rows, dim, queries, n_model, topk, method, bf16, integer)
CASES = {
    "oracle": (1000, 16, 37, 4, 25, "exact_sort", True, False),
    "uneven": (1003, 8, 5, 4, 50, "exact_sort", True, False),
    "approx": (4096, 16, 32, 4, 20, "approx", False, False),
    "int_exact_m4": (1003, 16, 37, 4, 25, "exact_sort", True, True),
    "int_auto_m2": (5001, 16, 64, 2, 40, "auto", False, True),
    "int_approx_bf16_m4": (4099, 8, 16, 4, 30, "approx", True, True),
    "int_k_over_shard_m4": (30, 8, 6, 4, 20, "exact_sort", True, True),
}


def _data(name):
    n, d, q, *_, integer = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if integer:
        return (rng.integers(-64, 65, (n, d)).astype(np.float32),
                rng.integers(-64, 65, (q, d)).astype(np.float32))
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(q, d)).astype(np.float32))


def _oracle(queries, items, topk):
    scores = queries @ items.T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :topk]
    return np.take_along_axis(scores, idx, axis=1), idx


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_search")
    cases = {}
    for name, (_, _, _, m, topk, method, bf16, _) in CASES.items():
        items, queries = _data(name)
        path = str(tmp / f"{name}.npz")
        np.savez(path, items=items, queries=queries)
        cases[name] = (path, m, topk, method, bf16)
    return W.run("sharded_search", 4, tmp, cases=cases,
                 service_dir=str(tmp / "svc"))


def test_every_rank_returns_the_same(searched):
    for r in searched[1:]:
        for k, v in searched[0].items():
            np.testing.assert_array_equal(r[k], v)


@pytest.mark.parametrize("name", ["oracle", "uneven"])
def test_sharded_matches_oracle(searched, name):
    items, queries = _data(name)
    topk = CASES[name][4]
    s, i = searched[0][f"{name}/scores"], searched[0][f"{name}/ids"]
    es, _ = _oracle(queries, items, topk)
    np.testing.assert_allclose(s, es, rtol=1e-4)
    # padding rows are never returned; the ids hold the scores they claim
    assert (i >= 0).all() and (i < len(items)).all()
    np.testing.assert_allclose(
        np.take_along_axis(queries @ items.T, i.astype(np.int64), axis=1),
        s, rtol=1e-4, atol=1e-5)


def test_uneven_corpus_pads_each_shard(searched):
    """1003 rows over 4 shards: 251 rows a shard, the last with one -inf
    padding row; 1000 divide into 250."""
    assert int(searched[0]["uneven/shard_rows"]) == 251
    assert int(searched[0]["oracle/shard_rows"]) == 250


def test_sharded_approx_mode(searched):
    items, queries = _data("approx")
    _, ei = _oracle(queries, items, 20)
    i = searched[0]["approx/ids"]
    recall = np.mean([len(set(i[r]) & set(ei[r])) / 20 for r in range(32)])
    assert recall > 0.85, recall


def test_int8_rejects_sharded(searched):
    assert all(bool(r["int8_refused"]) for r in searched)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("int_")])
def test_sharded_search_matches_jax_shard_map(searched, name):
    """The port's search against JAX's `shard_map` search of the same mesh
    shape (4 devices, 'model' of m): ids but for ties, scores within
    1e-6, exhausted slots (-inf, -1) alike."""
    items, queries = _data(name)
    _, _, _, m, topk, method, bf16, _ = CASES[name]
    mesh = jmake_mesh(num_model_shards=m, devices=jax.devices()[:4])
    js, ji = JMIPS(items, mesh=mesh, method=method, bf16=bf16).search(
        queries, topk)
    js, ji = np.asarray(js), np.asarray(ji)
    ps, pi = searched[0][f"{name}/scores"], searched[0][f"{name}/ids"]
    assert ps.shape == js.shape == (len(queries), min(topk, len(items)))
    np.testing.assert_allclose(ps, js, rtol=0, atol=1e-6)
    assert _sets_equal_but_ties(ps, pi, js, ji)
    assert int(searched[0][f"{name}/shard_rows"]) == -(-len(items) // m)


def test_service_on_a_mesh(searched):
    """`RetrievalService(mesh=)` shards its index over 'model' (203 items,
    51 a shard) and answers as the unsharded service; `save` writes from
    rank 0 only, and `load(..., mesh=)` answers the same again."""
    for r in searched:
        assert int(r["svc/index_rows"]) == 51
        assert not bool(r["svc/rank1_wrote"])
        np.testing.assert_allclose(r["svc/scores"], r["svc/plain_scores"],
                                   rtol=1e-6, atol=1e-7)
        assert _sets_equal_but_ties(r["svc/scores"], r["svc/ids"],
                                    r["svc/plain_scores"], r["svc/plain_ids"])
        np.testing.assert_array_equal(r["svc/loaded_ids"], r["svc/ids"])
        np.testing.assert_array_equal(r["svc/loaded_scores"], r["svc/scores"])
