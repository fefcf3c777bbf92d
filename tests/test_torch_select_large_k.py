"""Exact selection of any k <= C: the plan, the plain version, the sharded
search's merge.

B5 (`pallas_bitonic_topk`) and B3's stage (b) select in shared memory up
to 16384 candidates in one window, and past that while 2k <= 16384 on
their streaming path (a buffer of keys a query in shared memory, 8
adjacent queries a block of a candidate-major source where their buffers
fit); beyond, their global-memory mode takes any k <= C (`select_plan`
gives ``(0, C, 0, p)``; the kernels run on the card, `chip_smoke.py`
phases 5s and 5v). JAX has no such limit: the sharded search merges with
`lax.top_k`. Here:

* `select_plan` returns a plan for every k <= C at every C, the
  global-memory mode exactly where the shared-memory plans end, each
  shared-memory plan within a block's shared memory, and the
  global-memory mode's scratch (`large_scratch`, on the meta device)
  within its budget and of `large_scratch_bytes`'s layout;
* the plain version the kernels are held to against `jax.lax.top_k` at
  (4, 40,000) with k = 12,000 over bf16-rounded scores (ties), values and
  positions exactly, and past one window at small k over rows ascending,
  all equal and with -inf tails;
* `BruteForceMIPS` sharded over 'model' on four gloo ranks
  (`torch_parallel_workers.sharded_search`) at k = 9,000 over 40,000
  integer-valued rows, whose B5 merge takes 18,000 or 36,000 candidates,
  against JAX's sharded search of the same mesh shape: ids but for ties at
  the k-th score, scores within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from recbox_tpu.parallel import make_mesh as jmake_mesh
from recbox_tpu.retrieval import BruteForceMIPS as JMIPS
from recbox_tpu_torch.ops.bitonic_topk import (
    LARGE, LARGE_SCRATCH_BYTES, large_scratch, large_scratch_bytes,
    row_topk, select_plan, select_smem,
)
from test_torch_retrieval import _sets_equal_but_ties

_SMEM = 232448   # a block's shared memory on the H100
_WINDOW = 16384

_SHAPES = [(c, k) for c in (2, 300, 16384, 16385, 40_000, 131_072,
                            1_000_003)
           for k in (1, 2, 8192, 8193, 12_000, 16384, 65_536, c // 2, c)
           if 1 <= k <= c]
# the redesigned paths' own shapes: a chunk's per-segment rows of
# `segmented_mips_topk` (k = 93), B3's winners at 16.8M items for k = 500
# (streaming) and 10,000 (global memory)
_SHAPES += [(125_000, 93), (131_072, 500), (131_072, 10_000)]


@pytest.mark.parametrize("c,k", _SHAPES)
def test_select_plan_takes_every_k(c, k):
    """A plan for every k <= C: in shared memory where the first kernels'
    domain holds (within a block's shared memory), else the global-memory
    mode, whose scratch a chunk of queries stays within its budget (or is
    one query)."""
    qb, window, kpt, p = select_plan(c, k)
    assert p >= k and p & (p - 1) == 0
    if c > _WINDOW and k > _WINDOW // 2:
        assert (qb, window, kpt) == (LARGE, c, 0)
        scratch, chunk = large_scratch(1024, c, k, "meta")
        assert scratch.dtype == torch.uint8 and 1 <= chunk <= 1024
        assert scratch.numel() == large_scratch_bytes(chunk, c, k)
        assert chunk == 1 or scratch.numel() <= LARGE_SCRATCH_BYTES
        # one query's bin buffer holds every candidate, its survivors k
        assert large_scratch_bytes(1, c, k) >= 8 * c + 8 * k
        return
    assert select_smem(qb, c, window, p) <= _SMEM
    if c > _WINDOW:
        # the streaming path: a buffer of keys a query, fewer than C
        assert qb == 1 and kpt == 8 and max(p, 512, 2 * k) <= window < c
        return
    assert qb in (1, 2, 4) and window == c


@pytest.mark.parametrize("c,k", [(125_000, 93), (131_072, 500),
                                 (131_072, 1024), (131_072, 1025),
                                 (131_072, 1488), (131_072, 1489),
                                 (131_072, 2048), (131_072, 2049),
                                 (131_072, 8192), (16385, 1)])
def test_stream_plan_candidate_major(c, k):
    """Over a candidate-major source the streaming path takes 4 adjacent
    queries a block with the smaller of two buffers, 2304 keys (half an
    SM's shared memory) or 5952 (a block's most), that holds the sort's
    width and 2k and exceeds one query's buffer, else one query a block as
    a row-major source does; the global-memory mode does not depend on
    the layout."""
    qb, window, kpt, p = select_plan(c, k, cmajor=True)
    assert select_smem(qb, c, window, p) <= _SMEM
    assert max(p, 512, 2 * k) <= window < c
    # 8 scores a thread a tile in a block of 256 (one query), 16 in one of
    # 512 (four)
    assert kpt == (8 if qb == 1 else 16)
    assert (qb, window) == ((4, 2304) if k <= 1024 else (4, 5952)
                            if k <= 2048 else (1, 2 * p))
    if window == 2304:
        # two such blocks' shared memory fit an SM's 228 KB
        assert 2 * (select_smem(4, c, window, p) + 1024) <= 233472
    if window == 5952:
        assert select_smem(4, c, window + 32, p) > _SMEM
    if qb == 1:
        assert (qb, window, kpt, p) == select_plan(c, k)
    assert select_plan(c, 10_000 if c > 20_000 else c, cmajor=True) == \
        select_plan(c, 10_000 if c > 20_000 else c)


@pytest.mark.parametrize("rows,c,k", [(1024, 131_072, 10_000),
                                      (1024, 131_072, 65_536),
                                      (64, 40_000, 12_000),
                                      (7, 16_385, 16_385)])
def test_large_scratch_layout(rows, c, k):
    """The global-memory mode's scratch (`csrc/select_topk.cuh`
    `large_layout`): per row a 2048-bin histogram for each of up to 8
    splits, 20 ints of state, C bin keys and k survivors (u64), past one
    16384-key run a second k and the merges' split points, each array
    256-byte aligned; a chunk as many rows as `LARGE_SCRATCH_BYTES`
    holds."""
    def al(n):
        return -(-n // 256) * 256
    want = al(8 * rows * 2048 * 4) + al(rows * 80) + al(rows * c * 8) \
        + al(rows * k * 8)
    if k > 16384:
        want += al(rows * k * 8) + al(rows * -(-k // 4096) * 4)
    assert large_scratch_bytes(rows, c, k) == want
    scratch, chunk = large_scratch(rows, c, k, "meta")
    assert chunk == rows or large_scratch_bytes(
        chunk + 1, c, k) > LARGE_SCRATCH_BYTES - 6 * 256
    assert scratch.numel() <= LARGE_SCRATCH_BYTES


def test_select_plan_raises_only_past_the_candidates():
    with pytest.raises(ValueError, match="candidates"):
        select_plan(20_000, 20_001)
    assert select_plan(20_000, 20_000)[0] == LARGE


def test_plain_topk_matches_lax_top_k_past_8192():
    """(4, 40,000) bf16-rounded scores (ties) at k = 12,000: the plain
    version's values and positions equal `lax.top_k`'s."""
    rng = np.random.default_rng(0)
    s = rng.normal(size=(4, 40_000)).astype(np.float32)
    s = np.asarray(jnp.asarray(s).astype(jnp.bfloat16).astype(jnp.float32))
    assert len(np.unique(s[0])) < 40_000 // 4          # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(s), 12_000)
    pv, pi = row_topk(torch.from_numpy(s), None, 12_000)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def _ordered_rows(kind, q, c, seed):
    """(Q, C) f32 rows that stress a running threshold: 'ascending' (each
    key beats those before it), 'equal' (position alone decides),
    'neg_inf_tail' (N(0, 1) and the last 30% -inf)."""
    if kind == "ascending":
        return (np.arange(c, dtype=np.float32)[None, :]
                + np.arange(q, dtype=np.float32)[:, None])
    if kind == "equal":
        return np.full((q, c), 1.5, np.float32)
    s = np.random.default_rng(seed).normal(size=(q, c)).astype(np.float32)
    s[:, int(0.7 * c):] = -np.inf
    return s


@pytest.mark.parametrize("kind", ["ascending", "equal", "neg_inf_tail"])
@pytest.mark.parametrize("k", [1, 93, 500])
def test_plain_topk_matches_lax_top_k_on_ordered_rows(kind, k):
    """Past one window (4 x 40,000) at the streaming path's small k: the
    plain version's values and positions equal `lax.top_k`'s on rows that
    raise the threshold at every tile, tie on every key, or end in -inf."""
    s = _ordered_rows(kind, 4, 40_000, 11 + k)
    jv, ji = jax.lax.top_k(jnp.asarray(s), k)
    pv, pi = row_topk(torch.from_numpy(s), None, k)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


# name: (corpus rows, dim, queries, n_model, topk, method, bf16)
CASES = {"k9000_m4": (40_000, 8, 6, 4, 9000, "exact_sort", True),
         "k9000_m2": (40_000, 8, 6, 2, 9000, "exact_sort", True)}


def _data(name):
    n, d, q, *_ = CASES[name]
    rng = np.random.default_rng(31 + sorted(CASES).index(name))
    return (rng.integers(-64, 65, (n, d)).astype(np.float32),
            rng.integers(-64, 65, (q, d)).astype(np.float32))


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("select_large_k")
    cases = {}
    for name, (_, _, _, m, topk, method, bf16) in CASES.items():
        items, queries = _data(name)
        path = str(tmp / f"{name}.npz")
        np.savez(path, items=items, queries=queries)
        cases[name] = (path, m, topk, method, bf16)
    return W.run("sharded_search", 4, tmp, cases=cases,
                 service_dir=str(tmp / "svc"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_search_past_8192_matches_jax(searched, name):
    """k = 9,000 over 4 or 2 'model' shards of 40,000 integer rows: the
    merge of 36,000 or 18,000 candidates against JAX's sharded search, on
    every rank."""
    items, queries = _data(name)
    _, _, _, m, topk, method, bf16 = CASES[name]
    mesh = jmake_mesh(num_model_shards=m, devices=jax.devices()[:4])
    js, ji = JMIPS(items, mesh=mesh, method=method, bf16=bf16).search(
        queries, topk)
    js, ji = np.asarray(js), np.asarray(ji)
    assert select_plan(m * topk, topk)[0] == LARGE
    for r in searched:
        ps, pi = r[f"{name}/scores"], r[f"{name}/ids"]
        assert ps.shape == js.shape == (len(queries), topk)
        np.testing.assert_allclose(ps, js, rtol=0, atol=1e-6)
        assert _sets_equal_but_ties(ps, pi, js, ji)
