"""Exact selection of any k <= C: the plan, the plain version, the sharded
search's merge.

B5 (`pallas_bitonic_topk`) and B3's stage (b) select in shared memory up
to 16384 candidates, and past that while 2k <= 16384; beyond, their
global-memory mode takes any k <= C (`select_plan` gives ``(0, C, 0, p)``;
the kernels run on the card, `chip_smoke.py` phase 5v). JAX has no such
limit: the sharded search merges with `lax.top_k`. Here:

* `select_plan` returns a plan for every k <= C at every C, the
  global-memory mode exactly where the shared-memory plans end, and its
  scratch (`large_scratch`, on the meta device: the key copy only for a
  candidate-major source) within its budget;
* the plain version the kernels are held to against `jax.lax.top_k` at
  (4, 40,000) with k = 12,000 over bf16-rounded scores (ties), values and
  positions exactly;
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
    LARGE, LARGE_SCRATCH_BYTES, large_scratch, row_topk, select_plan,
    select_smem,
)
from test_torch_retrieval import _sets_equal_but_ties

_SMEM = 232448   # a block's shared memory on the H100
_WINDOW = 16384

_SHAPES = [(c, k) for c in (2, 300, 16384, 16385, 40_000, 131_072,
                            1_000_003)
           for k in (1, 2, 8192, 8193, 12_000, 16384, 65_536, c // 2, c)
           if 1 <= k <= c]


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
        keys, surv, chunk = large_scratch(1024, c, p, "meta")
        assert keys.shape == (chunk, c) and surv.shape == (chunk, p)
        assert keys.dtype == torch.int32 and surv.dtype == torch.int64
        assert chunk == 1 or chunk * (4 * c + 8 * p) <= LARGE_SCRATCH_BYTES
        # a row-major source is read in place: no key copy
        none, surv, rows = large_scratch(1024, c, p, "meta", keys=False)
        assert none is None and surv.shape == (rows, p) and rows >= chunk
        assert rows == 1 or rows * 8 * p <= LARGE_SCRATCH_BYTES
        return
    assert qb in (1, 2, 4) and window == min(c, _WINDOW)
    assert select_smem(qb, c, window, p) <= _SMEM


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
