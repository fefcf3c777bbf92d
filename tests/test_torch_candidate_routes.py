"""The dispatch rules of the redesigned candidate kernels, on the CPU.

B4 (`mips_segment_candidates`) has three CUDA routes chosen by an
explicit rule on (dtype, depth, plan, variant), and B3's stage (a)
(`mips_fused_topk`) takes the same rule; the segment route reads the corpus
through the 3-D view of `segment_view`, held here row by row against the
segments of the plain version and of JAX's kernel; B5 (`pallas_bitonic_topk`) and B3's stage (b) select in
windows planned by `select_plan`. The kernels run on the card
(`chip_smoke.py`); here the rules are held against the JAX package's block
plan and against the (C, k) domain the first B5 and B3 kernels took in
shared memory (k <= C up to 16384 candidates, k <= 8192 above; any k <= C
past that in the global-memory mode), and the plain top-k's tie order
against `lax.top_k`. Exact comparisons throughout: the rules are integer
arithmetic and the top-k of equal values is a total order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.ops.pallas.mips_topk import (
    _block_plan, mips_segment_candidates as jcands,
)
from recbox_tpu.retrieval.index import quantize_int8 as jquantize
from recbox_tpu_torch.ops import mips_fused_topk as fused_mod
from recbox_tpu_torch.ops.bitonic_topk import (
    LARGE, bitonic_topk_plain, pallas_bitonic_topk, select_plan, select_smem,
)
from recbox_tpu_torch.ops.mips_fused_topk import (
    mips_fused_topk, segment_plan,
)
from recbox_tpu_torch.ops.mips_topk import (
    PACK_FLOOR, PACK_MASK, SEGMENT, candidate_plan, candidate_route,
    mips_segment_candidates, mips_segment_candidates_plain, quantize_int8,
    route_launches, segment_view, segment_view_row,
)

_SMEM = 232448   # a block's shared memory on the H100


# -- B4: the route rule -------------------------------------------------------

@pytest.mark.parametrize("tile,n_seg", [(8192, 1), (4096, 2), (2048, 4),
                                        (1024, 8)])
def test_bf16_d128_plans_take_the_wgmma_route(tile, n_seg):
    """At D=128 bf16 and int8 the JAX plan of a query tile of 8192, 4096,
    2048 and 1024 queries has n_seg = 1, 2, 4, 8 (the port's plan is
    JAX's), and each takes the wgmma route; the 1024-query plan is the
    profiling path's."""
    sub, spb = _block_plan(jnp.bfloat16, tile, 128)
    sub_t, _ = candidate_plan(torch.bfloat16, 1_000_000, 128, tile)
    assert sub == sub_t == 128 * n_seg
    assert candidate_route(torch.bfloat16, 128, sub_t) == "wgmma"
    # int8 rows are half as wide: JAX's plan for the same tile is the same
    # until its 4 MB block budget binds
    sub8, _ = candidate_plan(torch.int8, 1_000_000, 128, tile)
    assert sub8 == _block_plan(jnp.int8, tile, 128)[0] == 128 * n_seg
    assert candidate_route(torch.int8, 128, sub8) == "wgmma"


@pytest.mark.parametrize("dtype,d,tile", [
    (torch.int8, 64, 1024),        # D = 64, the serving corpus's depth
    (torch.bfloat16, 64, 1024),
])
def test_d64_plans_take_the_wgmma_route(dtype, d, tile):
    sub, _ = candidate_plan(dtype, 1_000_000, d, tile)
    assert sub == 1024
    assert candidate_route(dtype, d, sub) == "wgmma"


# the small-query plans, on the tile route until the segment route came
_SEGMENT_PLANS = {(torch.bfloat16, 128, 512), (torch.bfloat16, 128, 20)}


@pytest.mark.parametrize("dtype,d,tile", [
    (torch.float32, 128, 1024),    # f32: no bf16 wgmma, TF32 would round
    (torch.bfloat16, 48, 1024),    # another depth
    (torch.bfloat16, 128, 512),    # n_seg = 16 > 8
    (torch.bfloat16, 128, 20),     # the small-query plans: n_seg = 128
])
def test_other_dtypes_depths_and_plans_take_the_tile_route(dtype, d, tile):
    """f32 and other depths take the tile route at any plan; the plans
    with n_seg outside {1, 2, 4, 8} (16 and 128 here) take the segment
    route when packed and stay on the tile route unpacked."""
    sub, _ = candidate_plan(dtype, 1_000_000, d, tile)
    if (dtype, d, tile) in _SEGMENT_PLANS:
        assert candidate_route(dtype, d, sub) == "segment"
        assert candidate_route(dtype, d, sub, packed=False) == "tile"
    else:
        assert candidate_route(dtype, d, sub) == "tile"
        assert candidate_route(dtype, d, sub, packed=False) == "tile"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("nq", [1, 8, 20, 64, 256, 600, 910, 911, 1024])
def test_served_request_plans_take_the_segment_route(dtype, d, nq):
    """Every request of 910 queries or fewer plans 9 to 256 segments a
    sub-chunk (JAX's plan for its query tile) and takes the segment route,
    packed; 911 queries plan 1024-row sub-chunks (n_seg 8) and, with 1024,
    keep the wgmma route."""
    sub, _ = segment_plan(dtype, 1_000_000, d, nq, 500)
    n_seg = sub // 128
    assert sub == _block_plan(_JAX_DTYPES[dtype], min(nq, 1024),
                              d + (-d) % 128)[0]
    if nq <= 910:
        assert 9 <= n_seg <= 256 and n_seg not in (1, 2, 4, 8)
        assert candidate_route(dtype, d, sub) == "segment"
    else:
        assert n_seg == 8 and candidate_route(dtype, d, sub) == "wgmma"


def test_route_pads_depth_to_sixteen_first():
    """The wrapper pads the depth to a multiple of 16 before the launch, so
    a 120-wide bf16 corpus is a 128-wide one to the rule and a 56-wide one
    a 64-wide one; 112 and 48 are neither."""
    assert candidate_route(torch.bfloat16, 120, 1024) == "wgmma"
    assert candidate_route(torch.int8, 56, 1024) == "wgmma"
    assert candidate_route(torch.bfloat16, 112, 1024) == "tile"
    assert candidate_route(torch.bfloat16, 48, 1024) == "tile"
    assert candidate_route(torch.bfloat16, 128, 1536) == "segment"  # n_seg 12
    assert candidate_route(torch.bfloat16, 112, 1536) == "tile"


_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
               torch.int8: jnp.int8}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("d", [64, 120, 128, 112])
@pytest.mark.parametrize("nq", [20, 600, 1024, 8192])
def test_fused_stage_a_route_at_jax_plans(dtype, d, nq):
    """B3's stage (a) at the JAX plan of its query tile (min(1024, Q)) over
    1M rows: for bf16 and int8 at a depth that pads to 64 or 128, the
    `wgmma` route with the 1024-query plan (n_seg = 8) and the segment
    route with the plans of 20 and 600 queries (n_seg 128 or 256, and 13);
    the tile route for f32 and for D = 112."""
    sub, _ = segment_plan(dtype, 1_000_000, d, nq, 500)
    assert sub == _block_plan(_JAX_DTYPES[dtype], min(nq, 1024),
                              d + (-d) % 128)[0]
    if dtype == torch.float32 or d == 112:
        want = "tile"
    else:
        want = "wgmma" if nq >= 1024 else "segment"
    assert candidate_route(dtype, d, sub) == want


def test_cpu_tensors_count_no_route():
    """The plain version (CPU tensors) launches nothing, on either route."""
    before = dict(route_launches)
    q = torch.randint(-3, 4, (8, 128)).to(torch.bfloat16)
    c = torch.randint(-3, 4, (2000, 128)).to(torch.bfloat16)
    mips_segment_candidates(q, c, packed=True)
    assert route_launches == before


# -- B4: the segment route's 3-D view ----------------------------------------

# (n_seg, query tile, corpus dtype): the JAX plans of 910, 600, 512, 20
# (bf16) and 20 (int8) queries at D = 128; corpora not a whole number of
# sub-chunks: two sub-chunks and a ragged third (its last row of segments
# partial, so the shifted view serves it), one whole sub-chunk, and one
# shorter than a sub-chunk (padded to a multiple of n_seg)
_VIEW_PLANS = [(9, 910, torch.bfloat16), (13, 600, torch.bfloat16),
               (16, 512, torch.bfloat16), (128, 20, torch.bfloat16),
               (256, 20, torch.int8)]


def _view_corpora(sub):
    return (2 * sub + sub // 3 + 7, sub, sub // 2 + 3)


def _view_rows(view, n_sub):
    """(n_sub · n_seg, 128) rows the view brings a segment, -1 for zeros."""
    return np.array([[segment_view_row(view, s, g, i) for i in range(SEGMENT)]
                     for s in range(n_sub) for g in range(view.n_seg)])


@pytest.mark.parametrize("n_seg,tile,dtype", _VIEW_PLANS)
def test_segment_view_rows_are_the_plans_segments(n_seg, tile, dtype):
    """For every sub-chunk s, segment g and index i the segment route's
    boxes bring row s·sub_rows + g + i·n_seg, the row the plain version
    and JAX's kernel assign there (`winner_ids`), where it is a row of the
    corpus, and zeros where it lies past the corpus (or its padding); no
    box reaches an address past the corpus the kernel sees."""
    sub, _ = candidate_plan(dtype, 1_000_000, 128, tile)
    assert sub == 128 * n_seg
    itemsize = torch.empty((), dtype=dtype).element_size()
    for n in _view_corpora(sub):
        view = segment_view(n, 128, itemsize, sub)
        n_sub = -(-n // sub)
        assert view.n_seg == n_seg and view.rows >= n
        assert view.dims == (128, n_seg, view.rows // n_seg)
        assert view.strides == (128 * itemsize, n_seg * 128 * itemsize)
        assert (view.pad_rows > 0) == (n < sub and n % n_seg != 0)
        assert (view.tail_sub >= 1) == (view.tail_segs > 0)
        rows = _view_rows(view, n_sub)
        want = (np.arange(n_sub)[:, None, None] * sub
                + np.arange(n_seg)[None, :, None]
                + np.arange(SEGMENT)[None, None, :] * n_seg
                ).reshape(-1, SEGMENT)
        np.testing.assert_array_equal(rows, np.where(want < view.rows, want,
                                                     -1))
        if n > sub:      # the shifted view serves the last rows
            assert view.tail_segs and any(segment_view_row(view, view.tail_sub, g, i)
                       == view.rows - 1 for g in range(n_seg)
                       for i in range(SEGMENT))


def _packed_through_view(q, c, scale, view, sub, valid):
    """The segment route's dataflow in numpy: each segment's rows gathered
    through the view (zeros past it), scored, packed with their index, the
    float max taken; candidate-major (n_sub · n_seg, Q) bits."""
    n_sub = -(-c.shape[0] // sub)
    rows = _view_rows(view, n_sub)
    cz = np.concatenate([c.astype(np.float64), np.zeros((1, c.shape[1]))])
    sz = np.ones(c.shape[0] + 1) if scale is None else \
        np.concatenate([scale.astype(np.float64), [1.0]])
    s = np.einsum("qd,prd->pqr", q.astype(np.float64), cz[rows])
    s = (s.astype(np.float32) * sz[rows][:, None, :].astype(np.float32))
    s = np.clip(s, -PACK_FLOOR, PACK_FLOOR).astype(np.float32)
    s = np.where(((rows >= 0) & (rows < valid))[:, None, :], s,
                 np.float32(-PACK_FLOOR))
    bits = (s.view(np.int32) & ~PACK_MASK) | np.arange(SEGMENT, dtype=np.int32)
    return bits.view(np.float32).max(axis=2).view(np.int32)


@pytest.mark.parametrize("n_seg,tile,dtype", _VIEW_PLANS)
def test_segment_view_candidates_equal_plain_and_jax(n_seg, tile, dtype):
    """Integer data through the view's gather (the segment route's boxes,
    folded as the kernel folds them) give the packed candidates of the
    plain version and of JAX's kernel (interpret mode, at ``tile`` queries
    and so the same plan) bit for bit, over a corpus two and a third
    sub-chunks long with the last 37 rows past valid_items."""
    sub, _ = candidate_plan(dtype, 1_000_000, 128, tile)
    n = _view_corpora(sub)[0]
    valid = n - 37
    rng = np.random.default_rng(n_seg)
    q = rng.integers(-4, 5, size=(tile, 128)).astype(np.float32)
    c = rng.integers(-4, 5, size=(n, 128)).astype(np.float32)
    jdt = _JAX_DTYPES[dtype]
    spb = _block_plan(jdt, tile, 128)[1]
    cp = np.concatenate([c, np.zeros(((-n) % (sub * spb), 128), np.float32)])
    if dtype == torch.int8:
        pc, pscale = quantize_int8(torch.from_numpy(c))
        pq = quantize_int8(torch.from_numpy(q))[0]
        jc, jscale = jquantize(jnp.asarray(cp))
        want = jcands(jquantize(jnp.asarray(q))[0], jc, valid_items=valid,
                      interpret=True, packed=True,
                      row_scale=jscale.reshape(-1, 1))
        scale = pscale.numpy()
    else:
        pc, pq = (torch.from_numpy(a).to(dtype) for a in (c, q))
        want = jcands(jnp.asarray(q, jdt), jnp.asarray(cp, jdt),
                      valid_items=valid, interpret=True, packed=True)
        scale = None
    view = segment_view(n, 128, pc.element_size(), sub)
    got = _packed_through_view(pq.float().numpy(), pc.float().numpy(), scale,
                               view, sub, valid)
    plain = mips_segment_candidates_plain(pq, pc, valid, True, None if
                                          scale is None else pscale, sub)
    n_live = got.shape[0]
    np.testing.assert_array_equal(got, plain.view(torch.int32).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(want).view(np.int32)[:n_live])


# -- B5: the selection plan ---------------------------------------------------

# both sides of each boundary of the domain: one window (C <= 16384) or
# several (k <= 8192), 32 or 64 keys a thread (C past 8192)
_SHAPES = [(c, k) for c in (10, 7936, 8192, 8193, 16384, 16385, 40_000)
           for k in (1, 500, 4096, 8192, 8193, 16384) if k <= c]


@pytest.mark.parametrize("c,k", _SHAPES)
def test_select_plan_takes_the_first_kernels_domain(c, k):
    """`select_plan` plans in shared memory exactly the (C, k) the first B5
    and B3 kernels (a bitonic sort in windows of up to 16384 keys) took,
    k <= C up to 16384 candidates and k <= 8192 above, every plan within a
    block's shared memory: one window up to 16384 candidates, the
    streaming path past it (a buffer of keys a query, fewer than C, that
    holds the sort's width and 2k); past that (k above 8192 over more than
    16384 candidates) the global-memory mode, ``(0, C, 0, p)``."""
    if c > 16384 and k > 8192:
        p = 1 << (k - 1).bit_length()
        assert select_plan(c, k) == (LARGE, c, 0, p)
        return
    qb, window, kpt, p = select_plan(c, k)
    assert p >= k and p & (p - 1) == 0
    assert select_smem(qb, c, window, p) <= _SMEM
    if c > 16384:
        # one query a block of a row-major source, 8 keys a thread a tile
        assert (qb, kpt) == (1, 8)
        assert max(p, 512, 2 * k) <= window < c
        return
    assert qb in (1, 2, 4)
    assert kpt in (8, 16, 32, 64) and window <= 256 * kpt
    assert kpt <= 32 if qb == 4 else kpt == 64 if qb == 2 else kpt >= 32
    assert window == c


# corpora of 1024-row sub-chunks (8 winners each) for 1024 queries at D=64:
# 16384 winners, and 16392 (past one window)
@pytest.mark.parametrize("n,k,fits", [
    (2_097_152, 16384, True), (2_098_176, 8192, True),
    (2_098_176, 8193, False)])
def test_fused_topk_domain_is_unchanged(n, k, fits):
    """B3's (C, k) domain over its live winners holds the first B3
    kernel's in shared memory (k = C at 16384, k = 8192 over more), and
    k = 8193 over more takes the global-memory mode. The CUDA path plans
    its selection before it looks at the device, so meta tensors reach the
    plan and then the device check, and launch nothing."""
    from recbox_tpu_torch.ops import mips_topk as mips_mod
    before = (dict(fused_mod.launches), dict(mips_mod.route_launches))
    q = torch.empty((1024, 64), dtype=torch.bfloat16, device="meta")
    c = torch.empty((n, 64), dtype=torch.bfloat16, device="meta")
    sub, n_cand = segment_plan(c.dtype, n, 64, 1024, k)
    assert sub == 1024 and n_cand >= k
    assert (select_plan(-(-n // 1024) * 8, k)[0] != LARGE) == fits
    with pytest.raises(ValueError, match="CUDA device"):
        mips_fused_topk(q, c, k)
    assert (fused_mod.launches, mips_mod.route_launches) == before


def test_select_plan_queries_a_block():
    """Four queries a block at the candidate path's shapes (16-byte loads
    of a candidate-major row, 32 keys a thread), two at 64 keys a thread,
    one where the survivors of more do not fit; past one window the
    streaming path, four adjacent queries a block of a candidate-major
    source while their buffers fit."""
    assert select_plan(7936, 500) == (4, 7936, 32, 512)
    assert select_plan(7812, 100) == (4, 7812, 32, 128)
    assert select_plan(300, 12) == (4, 300, 8, 16)
    assert select_plan(8192, 8192) == (1, 8192, 32, 8192)
    assert select_plan(16384, 2000) == (2, 16384, 64, 2048)
    assert select_plan(16384, 16384) == (1, 16384, 64, 16384)
    assert select_plan(40_000, 500) == (1, 1536, 8, 512)
    assert select_plan(40_000, 500, cmajor=True) == (4, 2304, 16, 512)
    assert select_plan(40_000, 1400, cmajor=True) == (4, 5952, 16, 2048)
    assert select_plan(40_000, 2000, cmajor=True) == (4, 5952, 16, 2048)
    assert select_plan(40_000, 2049, cmajor=True) == (1, 8192, 8, 4096)


def test_bitonic_k_above_candidates_raises_through_the_plan():
    """k > C raises before any kernel, as JAX's kernel does, on both
    entries; k above 8192 over more than 16384 candidates no longer does:
    it takes the global-memory mode."""
    with pytest.raises(ValueError, match="candidates"):
        select_plan(10, 11)
    with pytest.raises(ValueError, match="candidates"):
        pallas_bitonic_topk(torch.zeros((2, 10)), k=11)
    assert select_plan(20_000, 8193) == (LARGE, 20_000, 0, 16384)


@pytest.mark.parametrize("c,k", [(300, 50), (20_000, 500), (700, 700)])
def test_plain_topk_breaks_ties_like_lax_top_k(c, k):
    """bf16-rounded scores (many ties), a windowed width and k = C: the
    plain version the kernel is held against gives `lax.top_k`'s values
    and positions exactly."""
    rng = np.random.default_rng(c + k)
    s = rng.normal(size=(3, c)).astype(np.float32)
    s = np.array(jnp.asarray(s).astype(jnp.bfloat16).astype(jnp.float32))
    vals, pos = bitonic_topk_plain(torch.from_numpy(s), None, k)
    jv, jp = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))
