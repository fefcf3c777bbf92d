"""Port retrieval serving against the JAX package, on the CPU.

The port's fused MIPS top-k runs its plain PyTorch version here (its CUDA
kernel is held against that version on the card by `chip_smoke.py`); the
JAX kernel runs in Pallas interpret mode. Tolerances: f32 and int8 id sets
equal and scores within rtol 2e-5 (the packing truncates at 2^-17 and the
two sides sum in different orders); bf16 per-row overlap >= 0.99, since a
different summation order can flip packed near-ties.
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.base import MatchingModel as JMatchingModel
from recbox_tpu.models.matching import two_tower as jtt
from recbox_tpu.nn.embedding import FeatureEmbedding as JFeatureEmbedding
from recbox_tpu.ops.pallas.mips_fused_topk import mips_fused_topk as jfused
from recbox_tpu.ops.pallas.mips_topk import _block_plan
from recbox_tpu.retrieval.index import quantize_int8 as jquantize
from recbox_tpu.retrieval.service import RetrievalService as JService
from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.base import MatchingModel
from recbox_tpu_torch.models.matching import two_tower as ptt
from recbox_tpu_torch.nn.embedding import FeatureEmbedding
from recbox_tpu_torch.ops import mips_fused_topk as fused_mod
from recbox_tpu_torch.ops.mips_fused_topk import (
    mips_fused_topk, mips_fused_topk_plain, segment_plan,
)
from recbox_tpu_torch.retrieval import (
    BruteForceMIPS, RetrievalService, chunked_topk, quantize_int8,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_sub_rows(dtype, nq, d):
    """The JAX kernel's segment plan for a query tile of min(nq, 1024)."""
    return _block_plan(dtype, min(nq, 1024), d + (-d) % 128)[0]


def _sets_equal(a, b):
    return np.array_equal(np.sort(np.asarray(a), axis=1),
                          np.sort(np.asarray(b), axis=1))


def _overlap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.mean([len(set(a[r].tolist()) & set(b[r].tolist())) / a.shape[1]
                    for r in range(a.shape[0])])


@pytest.fixture(scope="module")
def corpus50k():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(20, 64)).astype(np.float32)
    c = rng.normal(size=(50_000, 64)).astype(np.float32)
    return q, c


# -- 1. fused top-k against JAX ----------------------------------------------

@pytest.mark.parametrize("variant", ["f32", "int8"])
def test_fused_topk_matches_jax(corpus50k, variant):
    q, c = corpus50k
    if variant == "int8":
        jc, jscale = jquantize(jnp.asarray(c))
        js, ji = jfused(q, jc, 10, valid_items=50_000, interpret=True,
                        row_scale=np.asarray(jscale))
        pc, pscale = quantize_int8(torch.from_numpy(c))
    else:
        js, ji = jfused(q, c, 10, interpret=True)
        pc, pscale = torch.from_numpy(c), None
    ps, pi = mips_fused_topk(torch.from_numpy(q), pc, 10, row_scale=pscale)
    assert ps.dtype == torch.float32 and pi.dtype == torch.int32
    assert _sets_equal(pi, ji)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=2e-5)
    assert (np.diff(ps.numpy(), axis=1) <= 0).all()


def test_fused_topk_bf16_matches_jax(corpus50k):
    q, c = corpus50k
    qb = np.asarray(jnp.asarray(q, jnp.bfloat16))
    cb = np.asarray(jnp.asarray(c, jnp.bfloat16))
    js, ji = jfused(qb, cb, 10, interpret=True)
    ps, pi = mips_fused_topk(
        torch.from_numpy(q).to(torch.bfloat16),
        torch.from_numpy(c).to(torch.bfloat16), 10)
    assert _overlap(pi, ji) >= 0.99
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-2)


# -- 2. fused top-k contract --------------------------------------------------

def test_fused_topk_negative_scores_with_padding():
    """Pad rows (>= valid_items) must never win a segment whose live rows
    all score negative; exhausted slots are (-inf, -1)."""
    rng = np.random.default_rng(13)
    q = np.abs(rng.normal(size=(8, 64))).astype(np.float32)
    c = -np.abs(rng.normal(size=(3000, 64))).astype(np.float32)
    for valid, k in [(2900, 5), (200, 30)]:
        js, ji = jfused(q, c, k, valid_items=valid, interpret=True)
        ps, pi = mips_fused_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                                 valid_items=valid)
        assert _sets_equal(pi, ji)
        assert ((pi >= 0) & (pi < valid)).all()
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=2e-5)
    # fewer live segments than k: trailing slots pad
    ps, pi = mips_fused_topk(torch.from_numpy(q), torch.from_numpy(c), 20,
                             valid_items=3)
    assert (pi[:, :3] >= 0).all() and (pi[:, 3:] == -1).all()
    assert torch.isneginf(ps[:, 3:]).all() and (ps[:, :3] < 0).all()


def test_fused_topk_query_tiling():
    """Rows are independent: a subset of queries returns the same rows as
    the full batch, and a JAX 8-query tile plan agrees with the port."""
    rng = np.random.default_rng(12)
    q = rng.normal(size=(20, 64)).astype(np.float32)
    c = rng.normal(size=(4000, 64)).astype(np.float32)
    full_s, full_i = mips_fused_topk(torch.from_numpy(q), torch.from_numpy(c),
                                     7, query_tile=8)
    part_s, part_i = mips_fused_topk(torch.from_numpy(q[5:9]),
                                     torch.from_numpy(c), 7, query_tile=8)
    assert torch.equal(part_i, full_i[5:9]) and torch.equal(part_s,
                                                            full_s[5:9])
    js, ji = jfused(q, c, 7, interpret=True, query_tile=8)
    assert _sets_equal(full_i, ji)


def test_fused_topk_argument_errors():
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(3000, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="segment candidates"):
        mips_fused_topk(q, c, 2000)
    c8, scale = quantize_int8(c)
    with pytest.raises(ValueError, match="row_scale"):
        mips_fused_topk(q, c8, 10)
    with pytest.raises(ValueError, match="only meaningful"):
        mips_fused_topk(q, c, 10, row_scale=scale)
    with pytest.raises(ValueError, match="entries"):
        mips_fused_topk(q, c8, 10, row_scale=scale[:-1])
    with pytest.raises(TypeError, match="dtype"):
        mips_fused_topk(q, c.to(torch.float16), 10)


@pytest.mark.parametrize("dtype,nq,d", [
    (jnp.float32, 20, 64), (jnp.bfloat16, 20, 64), (jnp.int8, 20, 64),
    (jnp.bfloat16, 600, 64), (jnp.bfloat16, 1024, 128), (jnp.float32, 1, 200),
])
def test_segment_plan_follows_jax_block_plan(dtype, nq, d):
    """The sub-chunk size is JAX's for the query tile: 20 queries at D=64
    give 8192 (f32), 16384 (bf16), 32768 (int8) rows; 600 give 1664, which
    is 13 segments, not a power of two."""
    tdtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
              jnp.int8: torch.int8}[dtype]
    sub, _ = segment_plan(tdtype, 1_000_000, d, nq, 10)
    assert sub == _jax_sub_rows(dtype, nq, d)
    if (dtype, nq) == (jnp.bfloat16, 600):
        assert sub == 1664


def test_fused_topk_600_queries_odd_segment_count():
    """At 600 queries the plan has 13 segments per sub-chunk. The JAX kernel
    does not run there (its merge window of 52 winners is not a power of
    two), so the port is held against the segment-winner rule in numpy."""
    rng = np.random.default_rng(15)
    q = rng.normal(size=(600, 16)).astype(np.float32)
    c = rng.normal(size=(7000, 16)).astype(np.float32)
    sub, _ = segment_plan(torch.float32, 7000, 16, 600, 5)
    assert sub // 128 == 13
    ps, pi = mips_fused_topk(torch.from_numpy(q), torch.from_numpy(c), 5)
    scores = q.astype(np.float64) @ c.T.astype(np.float64)
    rows = np.arange(7000)
    seg = (rows // sub) * 13 + (rows % sub) % 13
    win = np.stack([rows[seg == g][np.argmax(scores[:, seg == g], axis=1)]
                    for g in np.unique(seg)], axis=1)          # (600, n_seg)
    top = np.argsort(-np.take_along_axis(scores, win, axis=1), axis=1)[:, :5]
    # packing truncates scores at 2^-17, which can flip near-ties
    assert _overlap(pi, np.take_along_axis(win, top, axis=1)) >= 0.998
    np.testing.assert_allclose(
        ps.numpy(), np.take_along_axis(scores, pi.numpy().astype(np.int64),
                                       axis=1), rtol=2e-5)


@pytest.mark.parametrize("k", [40, 100])
def test_fused_topk_k_past_live_candidates_pads_like_jax(k):
    """N=3000, 4 queries: JAX counts candidates over the corpus padded to its
    grid block and returns (-inf, -1) past the live ones; so does the port,
    where it used to raise."""
    rng = np.random.default_rng(16)
    q = rng.normal(size=(4, 64)).astype(np.float32)
    c = rng.normal(size=(3000, 64)).astype(np.float32)
    js, ji = jfused(q, c, k, interpret=True)
    ps, pi = mips_fused_topk(torch.from_numpy(q), torch.from_numpy(c), k)
    assert pi.shape == (4, k) and ps.shape == (4, k)
    np.testing.assert_array_equal(pi.numpy() == -1, np.asarray(ji) == -1)
    assert _sets_equal(pi, ji)
    live = np.isfinite(np.asarray(js))
    np.testing.assert_array_equal(np.isfinite(ps.numpy()), live)
    np.testing.assert_allclose(ps.numpy()[live], np.asarray(js)[live],
                               rtol=2e-5)


def test_fused_topk_non_cpu_tensor_never_takes_plain_version():
    """Only a CPU tensor reaches the plain version: any other device goes
    to the kernel path, which raises rather than fall back."""
    before = dict(fused_mod.launches)
    q = torch.empty((4, 64), device="meta")
    c = torch.empty((3000, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        mips_fused_topk(q, c, 5)
    with pytest.raises(ValueError, match="CUDA device"):
        mips_fused_topk(q, c, 100)      # past the live candidates: pads
    assert fused_mod.launches == before


# -- 3. quantize_int8 ---------------------------------------------------------

def test_quantize_int8_matches_jax():
    rng = np.random.default_rng(3)
    items = rng.normal(size=(4096, 32)).astype(np.float32)
    items *= rng.uniform(0.1, 10.0, size=(4096, 1))
    items[7] = 0.0                                  # all-zero row
    jq, js = jquantize(jnp.asarray(items))
    pq, ps = quantize_int8(torch.from_numpy(items))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6)


# -- BruteForceMIPS -----------------------------------------------------------

@pytest.mark.parametrize("method", ["exact", "approx", "segmented", "auto"])
def test_index_methods_exact_on_small_corpus(method):
    """'approx'/'segmented' are an exact torch.topk here; 'auto' past the
    kernel's corpus:k gate falls to them; all equal the exact ranking."""
    rng = np.random.default_rng(4)
    items = rng.normal(size=(3000, 32)).astype(np.float32)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    idx = BruteForceMIPS(items, method=method, bf16=False, query_chunk=8,
                         chunk_size=512, device="cpu")
    s, i = idx.search(q, topk=300)
    assert i.dtype == torch.int32 and s.shape == (16, 300)
    exact = np.argsort(-(q @ items.T), axis=1)[:, :300]
    assert _sets_equal(i, exact)
    np.testing.assert_allclose(
        s.numpy(), np.take_along_axis(q @ items.T, i.numpy().astype(np.int64),
                                      axis=1), rtol=1e-5, atol=1e-5)


def test_index_auto_int8_and_cosine_route_to_kernel():
    rng = np.random.default_rng(5)
    items = rng.normal(size=(30_000, 32)).astype(np.float32)
    q = rng.normal(size=(6, 32)).astype(np.float32)
    idx = BruteForceMIPS(items, quantize="int8", device="cpu")
    assert idx.items is None and idx.q_items.dtype == torch.int8
    s, i = idx.search(q, topk=10)
    exact = np.argsort(-(q @ items.T), axis=1)[:, :10]
    assert _overlap(i, exact) >= 0.9
    cos = BruteForceMIPS(items, metric="cosine", bf16=False, device="cpu")
    s, i = cos.search(q, topk=10)
    nq = q / np.linalg.norm(q, axis=1, keepdims=True)
    ni = items / np.linalg.norm(items, axis=1, keepdims=True)
    assert _overlap(i, np.argsort(-(nq @ ni.T), axis=1)[:, :10]) >= 0.95
    assert float(s.max()) <= 1.0 + 1e-5


def test_index_later_slice_paths_raise():
    items = np.random.default_rng(6).normal(size=(256, 8)).astype(np.float32)
    for kw in [dict(method="refined"), dict(mesh=object()),
               dict(method="approx", quantize="int8"),
               dict(method="exact", quantize="int8")]:
        with pytest.raises(NotImplementedError):
            BruteForceMIPS(items, device="cpu", **kw)
    # int8 past the kernel's gate would be the XLA int8 sweep
    idx = BruteForceMIPS(items, quantize="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        idx.search(items[:2], topk=50)


def test_chunked_topk_matches_numpy():
    rng = np.random.default_rng(7)
    items = torch.from_numpy(rng.normal(size=(1000, 16)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    s, i = chunked_topk(q, items, 12, chunk_size=128)
    exact = torch.topk(q @ items.T, 12, dim=1)
    assert torch.equal(i.long(), exact.indices)
    torch.testing.assert_close(s, exact.values)


# -- 4/5. RetrievalService -------------------------------------------------------

N_USERS, N_ITEMS = 30, 40


def _mf_pair(n_items=N_ITEMS, dim=8):
    jfm = JFeatureMap("svc", (
        JFeatureSpec("user_id", "categorical", source="user",
                     vocab_size=N_USERS, embedding_dim=dim),
        JFeatureSpec("item_id", "categorical", source="item",
                     vocab_size=n_items, embedding_dim=dim)),
        query_index="user_id", corpus_index="item_id", num_items=n_items)
    pfm = FeatureMap("svc", (
        FeatureSpec("user_id", "categorical", source="user",
                    vocab_size=N_USERS, embedding_dim=dim),
        FeatureSpec("item_id", "categorical", source="item",
                    vocab_size=n_items, embedding_dim=dim)),
        query_index="user_id", corpus_index="item_id", num_items=n_items)
    jm = jtt.MF(feature_map=jfm, embedding_dim=dim)
    pm = ptt.MF(pfm, embedding_dim=dim, device="cpu")
    return jm, pm


def _transplant(jm, pm, user, item, scale=1.0):
    vu = jm.init(jax.random.PRNGKey(0), user, method=jm.encode_user)
    vi = jm.init(jax.random.PRNGKey(1), item, method=jm.encode_item)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * scale,
        {**fnn.meta.unbox(vu["params"]), **fnn.meta.unbox(vi["params"])})
    pm.load_state_dict(from_jax_params(params, pm))
    return {"params": params}


def test_service_exact_matches_jax_with_exclude():
    jm, pm = _mf_pair()
    users = {"user_id": np.arange(8, dtype=np.int32)}
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    # scale the 1e-4 init up so scores are far from f32 ties
    variables = _transplant(jm, pm, users, corpus, scale=1e4)
    jsvc = JService(jm, variables, corpus, method="exact")
    psvc = RetrievalService(pm, corpus, method="exact", batch_size=16,
                            device="cpu")
    js, ji = jsvc.query(users, k=5)
    ps, pi = psvc.query(users, k=5)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, rtol=1e-5)
    exclude = [list(ji[r, :2]) for r in range(4)] + [[]] * 4
    js, ji = jsvc.query(users, k=5, exclude=exclude)
    ps, pi = psvc.query(users, k=5, exclude=exclude)
    np.testing.assert_array_equal(pi, ji)
    for r in range(4):
        assert not set(exclude[r]) & set(pi[r].tolist())
    # exhausted pool: k + excludes beyond the catalog pads (-inf, -1)
    banned = [list(range(36))] * 8
    js, ji = jsvc.query(users, k=100, exclude=banned)
    ps, pi = psvc.query(users, k=100, exclude=banned)
    np.testing.assert_array_equal(pi, ji)
    assert pi.shape == (8, N_ITEMS) and (pi[:, 4:] == -1).all()
    assert psvc.num_items == N_ITEMS
    psvc.refresh_items({"item_id": np.arange(10, dtype=np.int32)})
    assert psvc.num_items == 10
    _, pi = psvc.query(users, k=4)
    assert int(pi.max()) < 10


class _JMultiInterest(JMatchingModel):
    """Fake 3-D tower: the user embedding cut into K interests."""

    def setup(self):
        self.user_embedding = JFeatureEmbedding(self.feature_map,
                                                source="user",
                                                name="user_embedding")
        self.item_embedding = JFeatureEmbedding(self.feature_map,
                                                source="item",
                                                name="item_embedding")

    def user_tower(self, batch, train=False):
        e = self.user_embedding(batch)["user_id"]
        return e.reshape(e.shape[0], 3, -1)

    def item_tower(self, batch, train=False):
        return self.item_embedding(batch)["item_id"]


class _PMultiInterest(MatchingModel):
    def __init__(self, feature_map):
        super().__init__(feature_map)
        g, dev = self.init_rng(None, "cpu")
        self.user_embedding = FeatureEmbedding(feature_map, source="user",
                                               generator=g, device=dev)
        self.item_embedding = FeatureEmbedding(feature_map, source="item",
                                               generator=g, device=dev)

    def user_tower(self, batch):
        e = self.user_embedding(batch)["user_id"]
        return e.reshape(e.shape[0], 3, -1)

    def item_tower(self, batch):
        return self.item_embedding(batch)["item_id"]


def test_service_multi_interest_merge_matches_jax():
    specs = [("user_id", "user", N_USERS, 24), ("item_id", "item", N_ITEMS, 8)]
    jfm = JFeatureMap("mi", tuple(
        JFeatureSpec(n, "categorical", source=s, vocab_size=v,
                     embedding_dim=d) for n, s, v, d in specs))
    pfm = FeatureMap("mi", tuple(
        FeatureSpec(n, "categorical", source=s, vocab_size=v,
                    embedding_dim=d) for n, s, v, d in specs))
    jm, pm = _JMultiInterest(feature_map=jfm), _PMultiInterest(pfm)
    users = {"user_id": np.arange(6, dtype=np.int32)}
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    variables = _transplant(jm, pm, users, corpus, scale=1e4)
    jsvc = JService(jm, variables, corpus, method="exact")
    psvc = RetrievalService(pm, corpus, method="exact", device="cpu")
    for exclude in (None, [[1, 2, 3]] * 3 + [[]] * 3):
        js, ji = jsvc.query(users, k=7, exclude=exclude)
        ps, pi = psvc.query(users, k=7, exclude=exclude)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(ps, js, rtol=1e-5)
        for r in range(6):     # per-row dedup
            assert len(set(pi[r].tolist())) == 7


def _youtubednn_pair(dim=16):
    def specs(S):
        return (S("user_id", "categorical", source="user", vocab_size=N_USERS,
                  embedding_dim=dim),
                S("hist", "sequence", source="user", vocab_size=20_001,
                  embedding_dim=dim, max_len=5, share_embedding="item_id",
                  padding_idx=20_000),
                S("item_id", "categorical", source="item", vocab_size=20_000,
                  embedding_dim=dim))
    kw = dict(embedding_dim=dim, hidden_units=(32, dim))
    jm = jtt.YoutubeDNN(feature_map=JFeatureMap("y", specs(JFeatureSpec)),
                        **kw)
    pm = ptt.YoutubeDNN(FeatureMap("y", specs(FeatureSpec)), device="cpu",
                        **kw)
    return jm, pm


def test_service_auto_matches_jax_kernel():
    """Port 'auto' (the kernel's plain version) over 20k items vs the JAX
    kernel in interpret mode over the JAX-encoded towers. At 1024 queries
    JAX's segment plan is the port's sub_rows=1024, so the id sets agree."""
    jm, pm = _youtubednn_pair()
    rng = np.random.default_rng(8)
    hist = rng.integers(0, 20_000, (1024, 5)).astype(np.int32)
    hist[:, 3:] = 20_000
    users = {"user_id": rng.integers(0, N_USERS, 1024).astype(np.int32),
             "hist": hist}
    corpus = {"item_id": np.arange(20_000, dtype=np.int32)}
    variables = _transplant(jm, pm, {k: v[:4] for k, v in users.items()},
                            {"item_id": corpus["item_id"][:4]}, scale=1e3)
    ju = np.asarray(jm.apply(variables, users, method=jm.encode_user))
    ji_emb = np.asarray(jm.apply(variables, corpus, method=jm.encode_item))
    js, ji = jfused(ju, ji_emb, 10, valid_items=20_000, interpret=True)
    psvc = RetrievalService(pm, corpus, method="auto", bf16=False,
                            device="cpu")
    assert psvc.index._kernel_gate(10)
    ps, pi = psvc.query(users, k=10)
    assert _sets_equal(pi, ji)
    np.testing.assert_allclose(ps, np.asarray(js), rtol=2e-5, atol=1e-6)


def test_service_auto_20_users_matches_jax_kernel():
    """20 users: JAX's plan has 8192-row sub-chunks for this f32 corpus, and
    the port's 'auto' route follows it, so the id sets agree with the JAX
    kernel on the same towers."""
    jm, pm = _youtubednn_pair()
    rng = np.random.default_rng(9)
    hist = rng.integers(0, 20_000, (20, 5)).astype(np.int32)
    users = {"user_id": rng.integers(0, N_USERS, 20).astype(np.int32),
             "hist": hist}
    corpus = {"item_id": np.arange(20_000, dtype=np.int32)}
    variables = _transplant(jm, pm, {k: v[:4] for k, v in users.items()},
                            {"item_id": corpus["item_id"][:4]}, scale=1e3)
    ju = np.asarray(jm.apply(variables, users, method=jm.encode_user))
    ji_emb = np.asarray(jm.apply(variables, corpus, method=jm.encode_item))
    js, ji = jfused(ju, ji_emb, 10, valid_items=20_000, interpret=True)
    psvc = RetrievalService(pm, corpus, method="auto", bf16=False,
                            device="cpu")
    assert psvc.index._kernel_gate(10)
    ps, pi = psvc.query(users, k=10)
    assert _sets_equal(pi, ji)
    np.testing.assert_allclose(ps, np.asarray(js), rtol=2e-5, atol=1e-6)
    # a fixed 1024-row plan keeps other candidates here
    _, old_i = mips_fused_topk_plain(torch.tensor(ju), torch.tensor(ji_emb),
                                     10, 20_000, sub_rows=1024)
    assert not _sets_equal(old_i, ji)


def test_service_save_load_roundtrip(tmp_path):
    jm, pm = _mf_pair(n_items=256, dim=16)
    users = {"user_id": np.arange(8, dtype=np.int32)}
    corpus = {"item_id": np.arange(256, dtype=np.int32)}
    _transplant(jm, pm, users, corpus, scale=1e4)
    svc = RetrievalService(pm, corpus, method="exact", device="cpu")
    s0, i0 = svc.query(users, k=5)
    svc.save(str(tmp_path / "svc"))
    assert sorted(os.listdir(tmp_path / "svc")) == [
        "item_embs.npy", "model.pt", "service.json"]
    _, fresh = _mf_pair(n_items=256, dim=16)
    svc2 = RetrievalService.load(str(tmp_path / "svc"), fresh, device="cpu")
    assert svc2.method == "exact" and svc2.num_items == 256
    s1, i1 = svc2.query(users, k=5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(s0, s1, rtol=1e-6)
    svc2.refresh_items({"item_id": np.arange(128, dtype=np.int32)})
    assert svc2.num_items == 128
    with pytest.raises(ValueError, match="exactly one"):
        RetrievalService(fresh, device="cpu")


# -- 6. imports and device ------------------------------------------------------

def test_port_imports_no_jax_and_no_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import recbox_tpu_torch\n"
        "for m in pkgutil.walk_packages(recbox_tpu_torch.__path__,"
        " 'recbox_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax')"
        " or m.startswith(('jax.', 'flax.'))"
        " or m == 'recbox_tpu' or m.startswith('recbox_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('recbox_tpu_torch.')]))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_entry_points_default_to_cuda(monkeypatch):
    """Without device=, entry points ask for the card and raise when there
    is none; they never drop to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = np.zeros((64, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BruteForceMIPS(items)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    jm, pm = _mf_pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalService(pm, {"item_id": np.arange(4, dtype=np.int32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptt.MF(pm.feature_map)
    assert resolve_device("cpu") == torch.device("cpu")
