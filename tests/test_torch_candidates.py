"""Port of the candidate kernels (B4 `mips_topk`, B5 `bitonic_topk`) against
the JAX package, on the CPU.

The port runs the kernels' plain PyTorch versions here (the CUDA kernels
are held against them on the card by `chip_smoke.py`); the JAX kernels run
in Pallas interpret mode. Tolerances: integer-valued inputs make every sum
exact, so candidate arrays must be equal bit for bit; int8 products are
exact integers, so int8 results are equal too; f32 random-normal data is
summed in other orders on the two sides, so id sets must be equal and
scores agree within rtol 2e-5 (the packing truncates at 2^-17). B5 is a
sort of the given values: equal values and ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.ops.pallas.bitonic_topk import (
    pallas_bitonic_topk as jbitonic,
    pallas_bitonic_topk_cmajor as jbitonic_cm,
)
from recbox_tpu.ops.pallas.mips_topk import (
    _block_plan, mips_segment_candidates as jcands, pallas_mips_topk as jmips,
)
from recbox_tpu.retrieval.index import quantize_int8 as jquantize
from recbox_tpu_torch.ops import bitonic_topk as bitonic_mod
from recbox_tpu_torch.ops import mips_topk as mips_mod
from recbox_tpu_torch.ops.bitonic_topk import (
    pallas_bitonic_topk, pallas_bitonic_topk_cmajor,
)
from recbox_tpu_torch.ops.mips_topk import (
    ALL_PAD_WINNER, candidate_plan, mips_segment_candidates,
    pallas_mips_topk, quantize_int8,
)


def _sets_equal(a, b):
    return np.array_equal(np.sort(np.asarray(a), axis=1),
                          np.sort(np.asarray(b), axis=1))


def _jax_pad(c, qt, dtype=jnp.float32):
    """The corpus padded with zero rows to JAX's grid block for a tile of
    qt queries over a ``dtype`` corpus, as `pallas_mips_topk` pads it."""
    d = c.shape[1]
    sub, spb = _block_plan(dtype, qt, d)
    return np.concatenate([c, np.zeros(((-c.shape[0]) % (sub * spb), d),
                                       c.dtype)])


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


# -- B4: mips_segment_candidates ----------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("packed", [True, False])
def test_candidates_integer_data_equal_jax(dtype, packed):
    """Integer-valued queries and corpus: every sum is exact, so the packed
    array (and, unpacked, the scores and the first-argmax ids, ties
    included) equal JAX's bit for bit. 3000 live rows of an 8192-row block:
    the pad rows are masked by valid_items."""
    rng = np.random.default_rng(21)
    q, c = _ints(rng, (8, 128)), _ints(rng, (3000, 128))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    cp = _jax_pad(c, 8, jdt)
    want = jcands(jnp.asarray(q, jdt), jnp.asarray(cp, jdt), valid_items=3000,
                  interpret=True, packed=packed)
    got = mips_segment_candidates(torch.from_numpy(q).to(tdt),
                                  torch.from_numpy(c).to(tdt), packed=packed)
    assert got[0].shape == want[0].shape if not packed else \
        got.shape == want.shape == (64 if dtype == "f32" else 128, 8)
    if packed:
        np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                      np.asarray(want).view(np.int32))
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_candidates_int8_packed_equal_jax():
    """s8 x s8 sums are exact and the row scale is one f32 product on both
    sides: the packed candidates are equal bit for bit."""
    rng = np.random.default_rng(22)
    q = rng.normal(size=(16, 64)).astype(np.float32)
    c = rng.normal(size=(40_000, 64)).astype(np.float32)
    cp = _jax_pad(c, 16, jnp.int8)
    jc, jscale = jquantize(jnp.asarray(np.pad(cp, ((0, 0), (0, 64)))))
    jq, _ = jquantize(jnp.asarray(np.pad(q, ((0, 0), (0, 64)))))
    want = jcands(jq, jc, valid_items=40_000, interpret=True, packed=True,
                  row_scale=jscale.reshape(-1, 1))
    pc, pscale = quantize_int8(torch.from_numpy(c))
    pq, _ = quantize_int8(torch.from_numpy(q))
    got = mips_segment_candidates(pq, pc, packed=True, row_scale=pscale)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("packed", [True, False])
def test_candidates_negative_scores_and_valid_items(packed):
    """All live scores negative: pad rows (valid_items and past N) never
    win a segment with a live row; segments of pads are ALL_PAD_WINNER
    (packed) or (-inf, first row of the segment) (unpacked), as JAX's. A
    1024-query tile plans 1024-row sub-chunks in an 8192-row block, so
    sub-chunks 3-7 hold no row of the corpus."""
    rng = np.random.default_rng(23)
    q = np.abs(_ints(rng, (1024, 128), 1, 4))
    c = -np.abs(_ints(rng, (3000, 128), 1, 4))
    cp = _jax_pad(c, 1024)
    assert cp.shape[0] == 8192
    for valid in (2900, 200):
        want = jcands(jnp.asarray(q), jnp.asarray(cp), valid_items=valid,
                      interpret=True, packed=packed)
        got = mips_segment_candidates(torch.from_numpy(q),
                                      torch.from_numpy(c),
                                      valid_items=valid, packed=packed)
        if packed:
            np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                          np.asarray(want).view(np.int32))
            dead = got.numpy() < -1e38
            assert dead.any() and (got.numpy()[dead] == ALL_PAD_WINNER).all()
        else:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            live = np.isfinite(got[0].numpy())
            assert (got[1].numpy()[live] < valid).all()


def test_candidate_plan_counts_jax_grid_block():
    """N=3000 rows give the candidates of JAX's padded 8192-row block, of
    which the first ceil(3000 / sub_rows) sub-chunks hold rows."""
    sub, n_cand = candidate_plan(torch.float32, 3000, 64, 8)
    assert (sub, n_cand) == (8192, 64)
    sub, n_cand = candidate_plan(torch.bfloat16, 1_000_000, 128, 1024)
    assert (sub, n_cand) == (1024, 7936)
    sub, n_cand = candidate_plan(torch.int8, 1_000_000, 128, 1024)
    assert (sub, n_cand) == (1024, 7936)


# -- B4: pallas_mips_topk ----------------------------------------------------

@pytest.fixture(scope="module")
def corpus50k():
    rng = np.random.default_rng(24)
    return (rng.normal(size=(16, 64)).astype(np.float32),
            rng.normal(size=(50_000, 64)).astype(np.float32))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("exact_merge", [True, False])
def test_mips_topk_matches_jax(corpus50k, packed, exact_merge):
    """Exact and approx merges (both exact on the CPU, JAX's approx_max_k
    included), packed and unpacked: equal id sets, scores rtol 2e-5."""
    q, c = corpus50k
    js, ji = jmips(q, c, 10, interpret=True, exact_merge=exact_merge,
                   packed=packed)
    ps, pi = pallas_mips_topk(torch.from_numpy(q), torch.from_numpy(c), 10,
                              exact_merge=exact_merge, packed=packed)
    assert ps.dtype == torch.float32 and pi.dtype == torch.int32
    assert _sets_equal(pi, ji)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=2e-5)
    assert (np.diff(ps.numpy(), axis=1) <= 0).all()


def test_mips_topk_bitonic_merge_matches_exact_and_jax():
    """merge='bitonic' equals the unpacked exact merge bit for bit (one
    total order), and JAX's bitonic merge on the same data."""
    rng = np.random.default_rng(25)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    c = rng.normal(size=(4000, 64)).astype(np.float32)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    s0, i0 = pallas_mips_topk(tq, tc, 9, exact_merge=True, packed=False)
    s1, i1 = pallas_mips_topk(tq, tc, 9, merge="bitonic")
    assert torch.equal(i0, i1) and torch.equal(s0, s1)
    js, ji = jmips(q, c, 9, interpret=True, merge="bitonic")
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), rtol=1e-5)


def test_mips_topk_int8_matches_jax(corpus50k):
    q, c = corpus50k
    jc, jscale = jquantize(jnp.asarray(c))
    js, ji = jmips(q, jc, 10, valid_items=50_000, interpret=True,
                   exact_merge=True, row_scale=np.asarray(jscale))
    pc, pscale = quantize_int8(torch.from_numpy(c))
    ps, pi = pallas_mips_topk(torch.from_numpy(q), pc, 10,
                              valid_items=50_000, row_scale=pscale)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("packed", [True, False])
def test_mips_topk_query_tiling_matches_jax(packed):
    """20 queries with query_tile=8: JAX sweeps three tiles of an 8-query
    plan, the port one launch of the same plan; the rows agree with JAX's
    and with the port's own single-tile call on a subset."""
    rng = np.random.default_rng(26)
    q = rng.normal(size=(20, 64)).astype(np.float32)
    c = rng.normal(size=(4000, 64)).astype(np.float32)
    js, ji = jmips(q, c, 7, interpret=True, exact_merge=True, packed=packed,
                   query_tile=8)
    ps, pi = pallas_mips_topk(torch.from_numpy(q), torch.from_numpy(c), 7,
                              exact_merge=True, packed=packed, query_tile=8)
    assert _sets_equal(pi, ji)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=2e-5)
    s8, i8 = pallas_mips_topk(torch.from_numpy(q[8:16]), torch.from_numpy(c),
                              7, exact_merge=True, packed=packed)
    assert torch.equal(i8, pi[8:16]) and torch.equal(s8, ps[8:16])


def test_mips_topk_pads_past_live_candidates_like_jax():
    """k above the live candidates of a 3000-row corpus, all-negative
    scores: (-inf, -1) exactly where JAX pads."""
    rng = np.random.default_rng(27)
    q = np.abs(rng.normal(size=(4, 64))).astype(np.float32)
    c = -np.abs(rng.normal(size=(3000, 64))).astype(np.float32)
    for packed in (True, False):
        js, ji = jmips(q, c, 40, interpret=True, exact_merge=True,
                       packed=packed)
        ps, pi = pallas_mips_topk(torch.from_numpy(q), torch.from_numpy(c),
                                  40, exact_merge=True, packed=packed)
        np.testing.assert_array_equal(pi.numpy() == -1, np.asarray(ji) == -1)
        assert _sets_equal(pi, ji)
        live = np.isfinite(np.asarray(js))
        np.testing.assert_array_equal(np.isfinite(ps.numpy()), live)
        assert ((pi.numpy()[live] >= 0) & (pi.numpy()[live] < 3000)).all()


def test_mips_topk_argument_errors_match_jax():
    rng = np.random.default_rng(28)
    q = rng.normal(size=(4, 64)).astype(np.float32)
    c = rng.normal(size=(3000, 64)).astype(np.float32)
    jc, jscale = jquantize(jnp.asarray(c))
    pc, pscale = quantize_int8(torch.from_numpy(c))
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    cases = [
        (dict(corpus=(jc, pc)), "row_scale"),
        (dict(corpus=(jc, pc), row_scale=(jscale, pscale), packed=False),
         "packed-only"),
        (dict(corpus=(jc, pc), row_scale=(jscale, pscale), merge="bitonic"),
         "packed-only"),
        (dict(row_scale=(jscale, pscale)), "only meaningful"),
        (dict(merge="bitonic", packed=True), "bitonic"),
        (dict(k=2000), "segment candidates"),
        (dict(k=2000, merge="bitonic"), "segment candidates"),
    ]
    for kw, match in cases:
        jkw = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
        pkw = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
        jcorp, pcorp = jkw.pop("corpus", c), pkw.pop("corpus", tc)
        jk, pk = jkw.pop("k", 5), pkw.pop("k", 5)
        with pytest.raises(ValueError, match=match):
            jmips(q, jcorp, jk, interpret=True, **jkw)
        with pytest.raises(ValueError, match=match):
            pallas_mips_topk(tq, pcorp, pk, **pkw)


# -- B5: bitonic top-k ---------------------------------------------------------

@pytest.mark.parametrize("q,c,k", [(8, 100, 10), (4, 256, 50), (3, 1000, 7),
                                   (5, 64, 64), (4, 5000, 50)])
def test_bitonic_matches_jax(q, c, k):
    """JAX's four shapes and one above its 4096-candidate block (its
    recursive block merge): equal values and ids."""
    rng = np.random.default_rng(q * c + k)
    s = rng.normal(size=(q, c)).astype(np.float32)
    js, ji = jbitonic(s, k=k, q_tile=8, interpret=True)
    ps, pi = pallas_bitonic_topk(torch.from_numpy(s), k=k)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    rs, ri = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


def test_bitonic_explicit_ids_and_duplicate_scores():
    """Equal scores: the id set at each score is JAX's; the port's order
    among them is position ascending (lax.top_k's)."""
    s = np.array([[1.0, 3.0, 3.0, 2.0, -1.0, 3.0, 0.0, 2.0]], np.float32)
    ids = np.arange(8, dtype=np.int32)[None] * 10
    js, ji = jbitonic(s, ids=ids, k=4, q_tile=8, interpret=True)
    ps, pi = pallas_bitonic_topk(torch.from_numpy(s), torch.from_numpy(ids),
                                 k=4)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert set(pi[0, :3].tolist()) == set(np.asarray(ji)[0, :3].tolist()) \
        == {10, 20, 50}
    assert pi[0].tolist() == [10, 20, 50, 30]


def test_bitonic_candidate_major_entry():
    """(C, Q) in, (k, Q) out, against JAX's candidate-major entry and the
    port's row-major one on the transpose."""
    rng = np.random.default_rng(29)
    s = rng.normal(size=(300, 6)).astype(np.float32)
    ids = rng.permutation(300 * 6).reshape(300, 6).astype(np.int32)
    js, ji = jbitonic_cm(s, ids, k=12, q_tile=8, interpret=True)
    ps, pi = pallas_bitonic_topk_cmajor(torch.from_numpy(s),
                                        torch.from_numpy(ids), k=12)
    assert ps.shape == (12, 6) and pi.shape == (12, 6)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    rs, ri = pallas_bitonic_topk(torch.from_numpy(s.T.copy()),
                                 torch.from_numpy(ids.T.copy()), k=12)
    assert torch.equal(rs.T, ps) and torch.equal(ri.T, pi)


def test_bitonic_k_above_candidates_raises():
    s = torch.zeros((2, 10))
    with pytest.raises(ValueError, match="candidates"):
        pallas_bitonic_topk(s, k=11)
    with pytest.raises(ValueError, match="candidates"):
        jbitonic(np.zeros((2, 10), np.float32), k=11, interpret=True)
    with pytest.raises(ValueError, match="candidates"):
        pallas_bitonic_topk_cmajor(s.T, s.T.to(torch.int32), k=11)


# -- CUDA path only for CUDA tensors -------------------------------------------

def test_non_cpu_tensors_never_take_plain_versions():
    """Only a CPU tensor reaches a plain version: any other device goes to
    the kernel path, which raises rather than fall back."""
    before = (dict(mips_mod.launches), dict(bitonic_mod.launches))
    q = torch.empty((4, 64), device="meta")
    c = torch.empty((3000, 64), device="meta")
    for kw in (dict(), dict(packed=False), dict(merge="bitonic")):
        with pytest.raises(ValueError, match="CUDA device"):
            pallas_mips_topk(q, c, 5, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        mips_segment_candidates(q, c, packed=True)
    with pytest.raises(ValueError, match="CUDA device"):
        pallas_bitonic_topk(torch.empty((4, 100), device="meta"), k=5)
    assert (mips_mod.launches, bitonic_mod.launches) == before


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """A library's file name hashes its source and every shared header, so
    an edited `.cuh` rebuilds the kernels and a stale library is never
    loaded; the three kernels of this slice are registered."""
    import shutil

    from recbox_tpu_torch.ops import _build
    assert {"mips_topk", "bitonic_topk", "embedding_gather"} <= set(
        _build.SOURCES)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._library(name) for name in _build.SOURCES}
    assert before == {name: _build._library(name) for name in _build.SOURCES}
    header = csrc / "mips_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._library(name) for name in _build.SOURCES}
    assert all(before[name] != after[name] for name in _build.SOURCES)
