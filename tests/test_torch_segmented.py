"""The port's `segmented_mips_topk` against the JAX package's, on the CPU.

The same numpy queries and items go through JAX's jitted
`segmented_mips_topk` (its per-segment `approx_max_k` is an exact top-k on
the CPU) and the port's (both of its selections B5's plain version here;
the CUDA kernel is held against that version on the card by
`chip_smoke.py` phase 5s). Tolerances: ids equal as sets but for ties at
the k-th score (`_sets_equal_but_ties`); scores within rtol 1e-6 (a few
f32 ulp: XLA's dot and torch's matmul sum the bf16 products in other
orders).
"""

import numpy as np
import pytest
import torch

from recbox_tpu.retrieval.index import BruteForceMIPS as JIndex
from recbox_tpu.retrieval.index import segmented_mips_topk as jsegmented
from recbox_tpu_torch.retrieval import BruteForceMIPS
from recbox_tpu_torch.retrieval import index as index_mod
from recbox_tpu_torch.retrieval.index import segmented_mips_topk
from test_torch_retrieval import _sets_equal_but_ties

# (items, dim, queries, k, query_chunk, seg_k, bf16): JAX's recall test
# (`tests/test_retrieval_index.py:114-130`); k = 93 with item and query
# padding; the budget binding (seg_k 13 of k = 100 over 8 segments); f32
# scores; the small corpus of `:161-175` at each of its k
CASES = [
    (20_000, 32, 64, 100, 64, 0, True),
    (20_003, 32, 70, 93, 32, 0, True),
    (20_000, 32, 64, 100, 64, 13, True),
    (20_000, 32, 64, 100, 64, 0, False),
    *((400, 16, 8, k, 8, 0, True) for k in (1, 9, 10, 13, 15)),
]


def _data(n, d, q, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _recall(ids, queries, items, k):
    exact = np.argsort(-(queries @ items.T), axis=1)[:, :k]
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                    for a, b in zip(np.asarray(ids), exact)])


@pytest.mark.parametrize("n,d,q,k,chunk,seg_k,bf16", CASES)
def test_segmented_matches_jax(n, d, q, k, chunk, seg_k, bf16):
    queries, items = _data(n, d, q)
    js, ji = jsegmented(queries, items, k, query_chunk=chunk, n_segments=8,
                        seg_k=seg_k, bf16=bf16)
    ps, pi = segmented_mips_topk(torch.from_numpy(queries),
                                 torch.from_numpy(items), k,
                                 query_chunk=chunk, n_segments=8,
                                 seg_k=seg_k, bf16=bf16)
    assert ps.dtype == torch.float32 and pi.dtype == torch.int32
    assert tuple(pi.shape) == (q, k)
    assert _sets_equal_but_ties(ps, pi, js, ji)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6)
    if seg_k == 13:
        # the per-segment budget binds: a true top-k item is lost, in JAX
        # as in the port
        assert _recall(pi, queries, items, k) < 1.0
        assert _recall(ji, queries, items, k) < 1.0


def test_segmented_two_selections_a_chunk():
    """Each query chunk is two B5 calls: the per-segment selection over
    (chunk·8, segment) rows, then the merge of the 8·seg_k candidates with
    their ids."""
    queries, items = _data(4_000, 16, 40)
    calls = []
    real = index_mod.pallas_bitonic_topk

    def spy(scores, ids=None, k=100):
        calls.append((tuple(scores.shape), ids is None, k))
        return real(scores, ids, k)

    index_mod.pallas_bitonic_topk = spy
    try:
        segmented_mips_topk(torch.from_numpy(queries),
                            torch.from_numpy(items), 50, query_chunk=16)
    finally:
        index_mod.pallas_bitonic_topk = real
    seg_k = 50 // 8 + 50 // 16
    assert calls == [((16 * 8, 500), True, seg_k),
                     ((16, 8 * seg_k), False, 50)] * 3


def test_segmented_outside_b5_domain_raises():
    """A segment shorter than seg_k is outside B5's domain: it raises,
    never answers another function."""
    queries, items = _data(64, 8, 4)
    with pytest.raises(ValueError):
        segmented_mips_topk(torch.from_numpy(queries),
                            torch.from_numpy(items), 4, n_segments=8,
                            seg_k=9, query_chunk=4)


@pytest.mark.parametrize("method,n,k", [
    ("segmented", 20_000, 100),   # N > 16·k: the segment merge
    ("auto", 20_000, 300),        # k >= 256 past the kernel's gate
    ("segmented", 300, 50),       # a small corpus falls to 'approx'
])
def test_index_routes_segmented_as_jax(method, n, k):
    """`BruteForceMIPS.search` takes JAX's branch (`index.py:465-471`):
    'segmented', or 'auto' at k >= 256 past the kernel's gate, when the
    corpus holds more than 16·k items; else 'approx'."""
    queries, items = _data(n, 32, 64, seed=3)
    jidx = JIndex(items, method=method, query_chunk=64)
    js, ji = jidx.search(queries, topk=k)
    routed = []
    real = index_mod.segmented_mips_topk

    def spy(*args, **kw):
        routed.append(True)
        return real(*args, **kw)

    index_mod.segmented_mips_topk = spy
    try:
        pidx = BruteForceMIPS(items, method=method, query_chunk=64,
                              device="cpu")
        ps, pi = pidx.search(queries, topk=k)
    finally:
        index_mod.segmented_mips_topk = real
    assert bool(routed) == (n > 16 * k)
    assert _sets_equal_but_ties(ps, pi, js, ji)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6)
