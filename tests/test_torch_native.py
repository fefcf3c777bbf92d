"""The port's native host kernels (`recbox_tpu_torch/retrieval/native.py`)
against the JAX package's (`recbox_tpu/retrieval/native.py`), on the CPU.

Both packages load a library built from the same C++ sources: JAX's
``native/librecbox_native.so`` (its Makefile) and the port's under
``build/native/`` (g++ at first use). Every paired case feeds both the same
numpy inputs at the same ``n_threads`` (the k-means sums in threads) and
requires equal arrays, bit for bit; the numpy fallbacks likewise. The
JAX-only cases of `tests/test_native_retrieval.py` and
`tests/test_native_fixes.py` are mirrored on the port's functions.
"""

import ctypes
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

import recbox_tpu.retrieval.native as jnat
import recbox_tpu_torch.retrieval.native as pnat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    items = rng.normal(size=(2000, 32)).astype(np.float32)
    queries = rng.normal(size=(64, 32)).astype(np.float32)
    return queries, items


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# -- the build -----------------------------------------------------------------

def test_native_builds_and_loads():
    assert pnat.native_available(), "g++ builds the library"
    lib = pnat.load_native(strict=True)
    path = pnat.build_info["path"]
    assert os.path.dirname(path) == str(pnat.BUILD_DIR)
    assert os.path.basename(path).startswith("librecbox_native-")
    assert path == str(pnat.library_path())
    assert lib is pnat.load_native()


def test_both_libraries_loaded_side_by_side(data):
    """JAX's library and the port's carry the same symbols: each stays in
    its own RTLD_LOCAL namespace and answers through its own handle."""
    queries, items = data
    jlib, plib = jnat.load_native(), pnat.load_native()
    assert jlib is not None and plib is not None and jlib is not plib
    assert os.path.realpath(jlib._name) != os.path.realpath(plib._name)
    assert ctypes.cast(jlib.rbn_topk_ip, ctypes.c_void_p).value \
        != ctypes.cast(plib.rbn_topk_ip, ctypes.c_void_p).value
    _equal(pnat.exact_topk(queries, items, 7, n_threads=2),
           jnat.exact_topk(queries, items, 7, n_threads=2))


def test_library_name_tracks_sources_and_flags(monkeypatch):
    base = pnat.library_path()
    monkeypatch.setattr(pnat, "CXX_FLAGS", pnat.CXX_FLAGS + ("-DX=1",))
    assert pnat.library_path() != base
    assert pnat.library_path().parent == base.parent


def test_failed_build_strict_raises_quiet_falls_back(monkeypatch, tmp_path,
                                                     caplog):
    monkeypatch.setattr(pnat, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pnat, "CXX_FLAGS",
                        pnat.CXX_FLAGS + ("-no-such-flag-x",))
    monkeypatch.setattr(pnat, "_LIB", None)
    monkeypatch.setattr(pnat, "_TRIED", False)
    with pytest.raises(RuntimeError, match="no-such-flag-x"):
        pnat.load_native(strict=True)
    monkeypatch.setattr(pnat, "_TRIED", False)
    with caplog.at_level(logging.WARNING, logger="recbox_tpu_torch"):
        assert pnat.load_native() is None
    assert "numpy fallbacks active" in caplog.text
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*tmp"))


_CONCURRENT = """
import sys
sys.path.insert(0, {repo!r})
from pathlib import Path
import recbox_tpu_torch.retrieval.native as n
n.BUILD_DIR = Path({d!r})
lib = n.load_native(strict=True)
print("BUILT", n.build_info["path"])
"""


def test_concurrent_builds_replace_atomically(tmp_path):
    """Two processes building the same library into one directory at once
    both load it, and no temporary file is left."""
    env = {**os.environ, "PYTHONPATH": ""}
    code = _CONCURRENT.format(repo=REPO, d=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    libs = list(tmp_path.glob("*.so"))
    assert len(libs) == 1 and not list(tmp_path.glob("*.tmp"))
    assert all(f"BUILT {libs[0]}" in o for o, _ in outs)


# -- exact top-k -----------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 10, 2000])
def test_exact_topk_equals_jax(data, k):
    queries, items = data
    _equal(pnat.exact_topk(queries, items, k, n_threads=THREADS),
           jnat.exact_topk(queries, items, k, n_threads=THREADS))


def test_exact_topk_matches_numpy(data):
    queries, items = data
    scores, ids = pnat.exact_topk(queries, items, k=10)
    full = queries @ items.T
    ref_ids = np.argsort(-full, axis=1)[:, :10]
    ref_scores = np.take_along_axis(full, ref_ids, axis=1)
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5)
    assert (ids == ref_ids).mean() > 0.99


def test_exact_topk_k_larger_than_corpus():
    rng = np.random.default_rng(1)
    items = rng.normal(size=(5, 8)).astype(np.float32)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    scores, ids = pnat.exact_topk(q, items, k=10)
    assert scores.shape == (3, 5) and ids.shape == (3, 5)
    _equal((scores, ids), jnat.exact_topk(q, items, k=10))


def test_exact_topk_rejects_dim_mismatch():
    q = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    items = np.random.default_rng(1).normal(size=(32, 32)).astype(np.float32)
    with pytest.raises(ValueError, match="dim mismatch"):
        pnat.exact_topk(q, items, k=5)


# -- IVF-Flat --------------------------------------------------------------------

@pytest.mark.parametrize("nlist,nprobe,iters", [(32, 16, 8), (16, 16, 5),
                                                (16, 4, 3)])
def test_ivf_equals_jax(data, nlist, nprobe, iters):
    queries, items = data
    kw = dict(nlist=nlist, nprobe=nprobe, kmeans_iters=iters, seed=5,
              n_threads=THREADS)
    p = pnat.IVFFlatIndex(**kw).fit(items)
    j = jnat.IVFFlatIndex(**kw).fit(items)
    _equal((p.centroids, p.list_ids, p.list_offsets),
           (j.centroids, j.list_ids, j.list_offsets))
    _equal(p.search(queries, k=10), j.search(queries, k=10))


def test_ivf_recall_vs_exact(data):
    queries, items = data
    _, exact_ids = pnat.exact_topk(queries, items, k=10)
    index = pnat.IVFFlatIndex(nlist=32, nprobe=16, kmeans_iters=8).fit(items)
    _, ivf_ids = index.search(queries, k=10)
    recall = np.mean([len(set(ivf_ids[q]) & set(exact_ids[q])) / 10
                      for q in range(len(queries))])
    assert recall > 0.75, recall
    full = pnat.IVFFlatIndex(nlist=16, nprobe=16, kmeans_iters=5).fit(items)
    _, full_ids = full.search(queries, k=10)
    recall_full = np.mean([len(set(full_ids[q]) & set(exact_ids[q])) / 10
                           for q in range(len(queries))])
    assert recall_full > 0.999


def test_ivf_lists_partition_items(data):
    _, items = data
    index = pnat.IVFFlatIndex(nlist=16, kmeans_iters=3).fit(items)
    assert sorted(index.list_ids.tolist()) == list(range(len(items)))
    assert index.list_offsets[-1] == len(items)


def test_ivf_rejects_zero_kmeans_iters():
    with pytest.raises(ValueError, match="kmeans_iters"):
        pnat.IVFFlatIndex(kmeans_iters=0)


def test_ivf_search_rejects_dim_mismatch(data):
    queries, items = data
    index = pnat.IVFFlatIndex(nlist=4, kmeans_iters=1).fit(items)
    with pytest.raises(ValueError, match="dim mismatch"):
        index.search(queries[:, :16], k=3)


# -- negative sampling -------------------------------------------------------------

@pytest.mark.parametrize("n_items,num_negs,seed", [(37, 16, 3),
                                                   (100_000, 4, 0)])
def test_negative_sampler_equals_jax(n_items, num_negs, seed):
    pos = (np.arange(500, dtype=np.int32) * 7919) % n_items
    _equal((pnat.sample_negatives_native(pos, n_items, num_negs, seed=seed,
                                         n_threads=THREADS),),
           (jnat.sample_negatives_native(pos, n_items, num_negs, seed=seed,
                                         n_threads=THREADS),))


def test_negative_sampler_excludes_positives():
    pos = np.arange(500, dtype=np.int32) % 37
    out = pnat.sample_negatives_native(pos, n_items=37, num_negs=16, seed=3)
    assert out.shape == (500, 16)
    assert (out != pos[:, None]).all()
    assert out.min() >= 0 and out.max() < 37
    counts = np.bincount(out.reshape(-1), minlength=37)
    assert counts.max() < counts[counts > 0].mean() * 1.5


def test_negative_sampler_rejects_one_item():
    with pytest.raises(ValueError, match="n_items > 1"):
        pnat.sample_negatives_native(np.zeros(3, np.int32), 1, 2)


# -- numpy fallbacks -------------------------------------------------------------

def test_numpy_fallback_paths_equal_jax(monkeypatch, data):
    monkeypatch.setattr(pnat, "load_native", lambda rebuild=False: None)
    monkeypatch.setattr(jnat, "load_native", lambda rebuild=False: None)
    queries, items = data
    s1, i1 = pnat.exact_topk(queries, items, k=5)
    ref = np.sort(queries @ items.T, axis=1)[:, ::-1][:, :5]
    np.testing.assert_allclose(s1, ref, rtol=1e-5)
    _equal((s1, i1), jnat.exact_topk(queries, items, k=5))
    kw = dict(nlist=8, nprobe=8, kmeans_iters=3)
    p = pnat.IVFFlatIndex(**kw).fit(items)
    j = jnat.IVFFlatIndex(**kw).fit(items)
    s2, i2 = p.search(queries, k=5)
    assert np.isfinite(s2).all()
    _equal((p.centroids, s2, i2), (j.centroids, *j.search(queries, k=5)))
    out = pnat.sample_negatives_native(np.zeros(10, np.int32), 5, 4)
    assert (out != 0).all()
    _equal((out,), (jnat.sample_negatives_native(np.zeros(10, np.int32),
                                                 5, 4),))
    assert pnat.vocab_encode_native(np.asarray(["a"]), {"a": 1}, 0) is None


# -- vocab encode --------------------------------------------------------------------

def test_vocab_encode_native_matches_dict_and_jax():
    rng = np.random.default_rng(0)
    vocab = {str(v): i + 1 for i, v in enumerate(rng.permutation(5000))}
    vals = rng.integers(0, 8000, 50_000).astype(str)   # ~37% OOV
    out = pnat.vocab_encode_native(vals, vocab, oov=0, n_threads=THREADS)
    want = np.asarray([vocab.get(v, 0) for v in vals], np.int32)
    np.testing.assert_array_equal(out, want)
    _equal((out,), (jnat.vocab_encode_native(vals, vocab, oov=0,
                                             n_threads=THREADS),))
    # raw bytes ('S') input declines the fast path: str(b'x') == "b'x'"
    assert pnat.vocab_encode_native(vals.astype("S"), vocab, oov=0) is None
    uvocab = {"héllo": 1, "wörld": 2, "plain": 3}
    uvals = np.asarray(["héllo", "nope", "plain", "wörld"])
    np.testing.assert_array_equal(
        pnat.vocab_encode_native(uvals, uvocab, oov=0), [1, 0, 3, 2])


@pytest.mark.parametrize("kind", ["int", "float", "object"])
def test_vocab_encode_native_dtypes_equal_jax(kind):
    rng = np.random.default_rng(2)
    base = rng.integers(0, 300, 6000)
    vals = {"int": base, "float": base.astype(np.float64),
            "object": base.astype(str).astype(object)}[kind]
    vocab = {str(v): i + 1 for i, v in enumerate(np.unique(vals[:3000]))}
    got = pnat.vocab_encode_native(vals, vocab, oov=0)
    _equal((got,), (jnat.vocab_encode_native(vals, vocab, oov=0),))


def test_tokenizer_encode_uses_native_above_threshold(monkeypatch):
    from recbox_tpu_torch.features.tokenizer import Tokenizer
    calls = []
    orig = pnat.vocab_encode_native

    def counted(*a, **kw):
        out = orig(*a, **kw)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(pnat, "vocab_encode_native", counted)
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 3000, 10_000).astype(str)
    t = Tokenizer()
    t.fit(vals[:5000])
    got = t.encode_category(vals)              # len >= 4096 -> native
    want = np.asarray([t.vocab.get(v, t.oov_token) for v in vals], np.int32)
    np.testing.assert_array_equal(got, want)
    assert calls == [True]
    obj = np.asarray(list(vals[:5000]) + [None, np.nan], object)
    got2 = t.encode_category(obj)
    assert got2[-1] == t.oov_token and got2[-2] == t.oov_token
    t.encode_category(vals[:100])              # below: the dict loop
    assert len(calls) == 2


# -- the rest of test_native_fixes.py ---------------------------------------------

def test_itemknn_keeps_topk_per_target_column():
    from recbox_tpu.models.matching.traditional import ItemKNN as JItemKNN
    from recbox_tpu_torch.models.matching.traditional import ItemKNN
    users = np.array([0, 0, 1, 1, 2, 2, 2])
    items = np.array([0, 3, 0, 1, 0, 2, 3])
    S = ItemKNN(topk=1, device="cpu").fit(users, items, 3, 4).W.numpy()
    np.testing.assert_allclose(
        S, np.asarray(JItemKNN(topk=1).fit(users, items, 3, 4).S),
        rtol=1e-6)
    assert np.all((S > 0).sum(axis=0) >= 1)
    for j in range(4):
        col = S[:, j]
        assert np.allclose(col[col > 0], col.max())
