"""The dispatch rules of the redesigned candidate kernels, on the CPU.

B4 (`mips_segment_candidates`) has two CUDA routes chosen by an explicit
rule on (dtype, depth, plan), and B3's stage (a) (`mips_fused_topk`) takes
the same rule; B5 (`pallas_bitonic_topk`) and B3's stage (b) select in
windows planned by `select_plan`. The kernels run on the card
(`chip_smoke.py`); here the rules are held against the JAX package's block
plan and against the (C, k) domain the first B5 and B3 kernels took (k <= C
up to 16384 candidates, k <= 8192 above), and the plain top-k's tie order
against `lax.top_k`. Exact comparisons throughout: the rules are integer
arithmetic and the top-k of equal values is a total order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.ops.pallas.mips_topk import _block_plan
from recbox_tpu_torch.ops import mips_fused_topk as fused_mod
from recbox_tpu_torch.ops.bitonic_topk import (
    bitonic_topk_plain, pallas_bitonic_topk, select_plan, select_smem,
)
from recbox_tpu_torch.ops.mips_fused_topk import (
    mips_fused_topk, segment_plan,
)
from recbox_tpu_torch.ops.mips_topk import (
    candidate_plan, candidate_route, mips_segment_candidates,
    route_launches,
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


@pytest.mark.parametrize("dtype,d,tile", [
    (torch.float32, 128, 1024),    # f32: no bf16 wgmma, TF32 would round
    (torch.bfloat16, 48, 1024),    # another depth
    (torch.bfloat16, 128, 512),    # n_seg = 16 > 8
    (torch.bfloat16, 128, 20),     # the small-query plans: n_seg = 128
])
def test_other_dtypes_depths_and_plans_take_the_tile_route(dtype, d, tile):
    sub, _ = candidate_plan(dtype, 1_000_000, d, tile)
    assert candidate_route(dtype, d, sub) == "tile"


def test_route_pads_depth_to_sixteen_first():
    """The wrapper pads the depth to a multiple of 16 before the launch, so
    a 120-wide bf16 corpus is a 128-wide one to the rule and a 56-wide one
    a 64-wide one; 112 and 48 are neither."""
    assert candidate_route(torch.bfloat16, 120, 1024) == "wgmma"
    assert candidate_route(torch.int8, 56, 1024) == "wgmma"
    assert candidate_route(torch.bfloat16, 112, 1024) == "tile"
    assert candidate_route(torch.bfloat16, 48, 1024) == "tile"
    assert candidate_route(torch.bfloat16, 128, 1536) == "tile"   # n_seg 12


_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
               torch.int8: jnp.int8}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("d", [64, 120, 128, 112])
@pytest.mark.parametrize("nq", [20, 600, 1024, 8192])
def test_fused_stage_a_route_at_jax_plans(dtype, d, nq):
    """B3's stage (a) at the JAX plan of its query tile (min(1024, Q)) over
    1M rows: the `wgmma` route for bf16 and int8 at a depth that pads to
    64 or 128 with the 1024-query plan (n_seg = 8); the tile route for f32,
    for D = 112, and for the plans of 20 and 600 queries (n_seg 128 or 256,
    and 13)."""
    sub, _ = segment_plan(dtype, 1_000_000, d, nq, 500)
    assert sub == _block_plan(_JAX_DTYPES[dtype], min(nq, 1024),
                              d + (-d) % 128)[0]
    wgmma = (dtype != torch.float32 and d != 112 and nq >= 1024)
    assert candidate_route(dtype, d, sub) == ("wgmma" if wgmma else "tile")


def test_cpu_tensors_count_no_route():
    """The plain version (CPU tensors) launches nothing, on either route."""
    before = dict(route_launches)
    q = torch.randint(-3, 4, (8, 128)).to(torch.bfloat16)
    c = torch.randint(-3, 4, (2000, 128)).to(torch.bfloat16)
    mips_segment_candidates(q, c, packed=True)
    assert route_launches == before


# -- B5: the selection plan ---------------------------------------------------

# both sides of each boundary of the domain: one window (C <= 16384) or
# several (k <= 8192), 32 or 64 keys a thread (C past 8192)
_SHAPES = [(c, k) for c in (10, 7936, 8192, 8193, 16384, 16385, 40_000)
           for k in (1, 500, 4096, 8192, 8193, 16384) if k <= c]


@pytest.mark.parametrize("c,k", _SHAPES)
def test_select_plan_takes_the_first_kernels_domain(c, k):
    """`select_plan` accepts exactly the (C, k) the first B5 and B3 kernels
    (a bitonic sort in windows of up to 16384 keys) took, k <= C up to
    16384 candidates and k <= 8192 above, and raises ValueError elsewhere;
    every plan fits a block's shared memory."""
    if c > 16384 and k > 8192:
        with pytest.raises(ValueError,
                           match=f"above the kernel's 8192 for {c} "
                                 "candidates"):
            select_plan(c, k)
        return
    qb, window, kpt, p = select_plan(c, k)
    assert qb in (1, 2, 4) and p >= k and p & (p - 1) == 0
    assert kpt in (8, 16, 32, 64) and window <= 256 * kpt
    assert kpt <= 32 if qb == 4 else kpt == 64 if qb == 2 else kpt >= 32
    assert window == min(c, 16384)
    assert window == c or (qb == 1 and window >= k)
    assert select_smem(qb, c, window, p) <= _SMEM


# corpora of 1024-row sub-chunks (8 winners each) for 1024 queries at D=64:
# 16384 winners, and 16392 (past one window)
@pytest.mark.parametrize("n,k,fits", [
    (2_097_152, 16384, True), (2_098_176, 8192, True),
    (2_098_176, 8193, False)])
def test_fused_topk_domain_is_unchanged(n, k, fits):
    """B3's (C, k) domain over its live winners is the first B3 kernel's:
    k = C at 16384, k = 8192 over more, and k = 8193 over more raises. The
    CUDA path plans its selection before it looks at the device, so meta
    tensors reach the plan and then the device check, and launch
    nothing."""
    from recbox_tpu_torch.ops import mips_topk as mips_mod
    before = (dict(fused_mod.launches), dict(mips_mod.route_launches))
    q = torch.empty((1024, 64), dtype=torch.bfloat16, device="meta")
    c = torch.empty((n, 64), dtype=torch.bfloat16, device="meta")
    sub, n_cand = segment_plan(c.dtype, n, 64, 1024, k)
    assert sub == 1024 and n_cand >= k
    match = "CUDA device" if fits else \
        f"above the kernel's 8192 for {-(-n // 1024) * 8} candidates"
    with pytest.raises(ValueError, match=match):
        mips_fused_topk(q, c, k)
    assert (fused_mod.launches, mips_mod.route_launches) == before


def test_select_plan_queries_a_block():
    """Four queries a block at the candidate path's shapes (16-byte loads
    of a candidate-major row, 32 keys a thread), two at 64 keys a thread,
    one where the survivors of more do not fit, and when windowed."""
    assert select_plan(7936, 500) == (4, 7936, 32, 512)
    assert select_plan(7812, 100) == (4, 7812, 32, 128)
    assert select_plan(300, 12) == (4, 300, 8, 16)
    assert select_plan(8192, 8192) == (1, 8192, 32, 8192)
    assert select_plan(16384, 2000) == (2, 16384, 64, 2048)
    assert select_plan(16384, 16384) == (1, 16384, 64, 16384)
    assert select_plan(40_000, 500) == (1, 16384, 64, 512)


def test_bitonic_k_above_candidates_raises_through_the_plan():
    """k > C raises before any kernel, as JAX's kernel does, on both
    entries; k above 8192 over more than 16384 candidates too."""
    with pytest.raises(ValueError, match="candidates"):
        select_plan(10, 11)
    with pytest.raises(ValueError, match="candidates"):
        pallas_bitonic_topk(torch.zeros((2, 10)), k=11)
    with pytest.raises(ValueError, match="8192 for 20000 candidates"):
        select_plan(20_000, 8193)


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
