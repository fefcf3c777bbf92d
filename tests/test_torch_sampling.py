"""The port's negative sampler and `MatchingLoader` against the JAX
package's, on the CPU: bit for bit (dtypes included), from the same numpy
seeds.

- `AliasTable` (its tables and its draws), `popularity_distribution` for
  strategies 0-3 (and an all-zero count vector), and `sample_negatives`
  for every flag: uniform and popularity draws, ``exclude_pos``,
  ``seen_matrix`` / ``user_rows``, ``exclude_ids`` (with and without
  probabilities), a bounded re-draw that gives up
  (``max_resample_rounds``), and the seen-matrix error.
- `MatchingLoader`: two epochs in a row and `peek_batch`, array for array,
  with ``exclude_seen``, ``exclude_ids``, popularity probabilities,
  ``exclude_pos``, ``shuffle=False`` and the ValueErrors (asserts in JAX).
"""

import numpy as np
import pytest

from recbox_tpu.data import loader as jloader
from recbox_tpu.data import sampling as jsampling
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu_torch.data import loader as ploader
from recbox_tpu_torch.data import sampling as psampling
from recbox_tpu_torch.features import FeatureMap, FeatureSpec

N_USERS, N_ITEMS = 25, 60


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _counts(seed=0):
    rng = np.random.default_rng(seed)
    c = rng.zipf(1.5, N_ITEMS).astype(np.float64)
    c[:5] = 0
    return c


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_popularity_distribution(strategy):
    c = _counts()
    _equal(jsampling.popularity_distribution(c, strategy),
           psampling.popularity_distribution(c, strategy))
    z = np.zeros(7)
    _equal(jsampling.popularity_distribution(z, strategy),
           psampling.popularity_distribution(z, strategy))


def test_alias_table():
    p = jsampling.popularity_distribution(_counts(1), 1)
    jt, pt = jsampling.AliasTable(p), psampling.AliasTable(p)
    _equal(jt.prob, pt.prob)
    _equal(jt.alias, pt.alias)
    _equal(jt.sample((40, 3), np.random.default_rng(3)),
           pt.sample((40, 3), np.random.default_rng(3)))


FLAGS = {
    "uniform": {},
    "popularity": {"probs": True},
    "exclude_pos": {"exclude_pos": True},
    "seen": {"seen": True},
    "exclude_ids": {"exclude_ids": (0, 3, N_ITEMS - 1, N_ITEMS + 5)},
    "exclude_ids_pop": {"exclude_ids": (0, 3), "probs": True},
    "all": {"probs": True, "exclude_pos": True, "seen": True,
            "exclude_ids": (1, 2)},
    "gives_up": {"seen": "dense", "max_resample_rounds": 2},
}


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
def test_sample_negatives(flags):
    f = dict(FLAGS[flags])
    rng = np.random.default_rng(11)
    n = 200
    pos = rng.integers(0, N_ITEMS, n)
    users = rng.integers(0, N_USERS, n)
    kw = {}
    if f.pop("probs", False):
        kw["probs"] = jsampling.popularity_distribution(_counts(2), 1)
    seen = f.pop("seen", False)
    if seen:
        m = np.zeros((N_USERS, N_ITEMS), bool)
        m[users, pos] = True
        if seen == "dense":               # every user has seen nearly all
            m[:, :N_ITEMS - 1] = True
        kw.update(seen_matrix=m, user_rows=users)
    kw.update(f)
    a = jsampling.sample_negatives(pos, N_ITEMS, 4,
                                   np.random.default_rng(5), **kw)
    b = psampling.sample_negatives(pos, N_ITEMS, 4,
                                   np.random.default_rng(5), **kw)
    _equal(a, b)
    if flags == "gives_up":               # collisions are left after 2 rounds
        assert kw["seen_matrix"][users[:, None], b].any()
    if "exclude_ids" in kw and flags != "all":
        assert not np.isin(b, kw["exclude_ids"]).any()
    with pytest.raises(ValueError, match="user_rows"):
        psampling.sample_negatives(pos, N_ITEMS, 2, np.random.default_rng(0),
                                   seen_matrix=np.zeros((2, 2), bool))


def _maps():
    specs = [("user_id", "user", N_USERS), ("item_id", "item", N_ITEMS),
             ("item_cat", "item", 7)]
    kw = dict(query_index="user_id", corpus_index="item_id",
              num_items=N_ITEMS)
    return (JFeatureMap("s", tuple(JFeatureSpec(n, "categorical", s,
                                                vocab_size=v,
                                                embedding_dim=4)
                                   for n, s, v in specs), **kw),
            FeatureMap("s", tuple(FeatureSpec(n, "categorical", s,
                                              vocab_size=v, embedding_dim=4)
                                  for n, s, v in specs), **kw))


def _arrays(seed=0, n=301):
    rng = np.random.default_rng(seed)
    train = {"user_id": rng.integers(0, N_USERS, n).astype(np.int32),
             "item_id": rng.integers(0, N_ITEMS, n).astype(np.int32),
             "label": rng.random(n).astype(np.float32)}
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32),
              "item_cat": (np.arange(N_ITEMS) % 7).astype(np.int32)}
    return train, corpus


LOADERS = {
    "default": {},
    "exclude_seen": {"exclude_seen": True, "num_negs": 3},
    "popularity_exclude_ids": {"sampling_probs": True,
                               "exclude_ids": (0, 1), "exclude_pos": True},
    "no_shuffle": {"shuffle": False, "num_negs": 1},
}


@pytest.mark.parametrize("case", list(LOADERS), ids=list(LOADERS))
def test_matching_loader_matches_jax(case):
    jfm, pfm = _maps()
    train, corpus = _arrays()
    kw = dict(batch_size=64, seed=7, **LOADERS[case])
    if kw.pop("sampling_probs", False):
        kw["sampling_probs"] = psampling.popularity_distribution(
            _counts(4), 2)
    jl = jloader.MatchingLoader(jfm, train, corpus, **kw)
    pl_ = ploader.MatchingLoader(pfm, train, corpus, **kw)
    if "exclude_seen" in kw:
        _equal(jl.seen_matrix, pl_.seen_matrix)
    _equal(jl.peek_batch(), pl_.peek_batch())
    for _ in range(2):                    # two epochs in a row
        jb, pb = list(jl), list(pl_)
        assert len(jb) == len(pb) == len(pl_) == 301 // 64
        for a, b in zip(jb, pb):
            _equal(a, b)
            assert b["item::item_cat"].shape == (64, 1 + pl_.num_negs)
            np.testing.assert_array_equal(b["__item_ids__"][:, 0],
                                          b["item_id"])
    _equal(jl.peek_batch(), pl_.peek_batch())


def test_matching_loader_errors():
    _, pfm = _maps()
    train, corpus = _arrays()
    with pytest.raises(ValueError, match="corpus_index"):
        ploader.MatchingLoader(pfm, {"user_id": train["user_id"]}, corpus)
    with pytest.raises(ValueError, match="exclude_seen"):
        ploader.MatchingLoader(pfm, {"item_id": train["item_id"]}, corpus,
                               exclude_seen=True)
