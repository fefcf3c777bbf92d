"""Port kernel B2 (flash-CE) against the JAX package, on the CPU.

The port's `fused_softmax_ce` / `fused_multinomial_ce` run their plain
PyTorch sweeps here (the CUDA kernel is held against them on the card by
`chip_smoke.py`); JAX's kernel runs in Pallas interpret mode, as
`tests/test_pallas_kernels.py:349-540` runs it, on the same numpy inputs.

Tolerances. The loss agrees with the XLA formulation (`full_softmax_loss`
over bf16 x bf16 -> f32 logits) within 1e-5 relative. Against JAX's
kernel it agrees within 5e-4 relative: that kernel rounds each exp term to
bf16 before its row-sum (the MXU sum, `fused_ce.py:122-129`), the port sums
them in f32. Gradients agree with JAX's kernel within 0.5% of max |ref|:
both round p to bf16 before the products, and the two sides' f32 exps may
round to neighbouring bf16 values. The XLA formulation keeps p in f32, so
against it the gradients agree within 1% (that rounding alone reaches
~0.4% here; the JAX package allows 2%). The weight and mask cotangents
agree within 2e-3 absolute, the JAX package's own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.ops.losses import full_softmax_loss as jfull_softmax_loss
from recbox_tpu.ops.pallas.fused_ce import (
    fused_multinomial_ce as jmce, fused_softmax_ce as jce,
)
from recbox_tpu_torch.ops import _build
from recbox_tpu_torch.ops import fused_ce as fce
from recbox_tpu_torch.ops.fused_ce import (
    ce_operands, fused_ce_bwd_plain, fused_ce_lse_plain,
    fused_multinomial_ce, fused_softmax_ce,
)
from recbox_tpu_torch.ops.losses import full_softmax_loss

GRAD_REL = 5e-3


def _close(got, want, rel=GRAD_REL):
    want = np.asarray(want)
    err = float(np.max(np.abs(np.asarray(got) - want)))
    assert err <= rel * float(np.max(np.abs(want))), (err, rel)


def _port(fn, user, table, ids, extra=None):
    """Loss and gradients of a port op on CPU leaf tensors."""
    u = torch.tensor(user, requires_grad=True)
    t = torch.tensor(table, requires_grad=True)
    e = None if extra is None else torch.tensor(extra, requires_grad=True)
    loss = fn(u, t, torch.from_numpy(ids), e)
    loss.backward()
    return (float(loss), u.grad.numpy(), t.grad.numpy(),
            None if e is None else e.grad.numpy())


def _xla(user, table, labels):
    s = jnp.dot(user.astype(jnp.bfloat16), table.astype(jnp.bfloat16).T,
                preferred_element_type=jnp.float32)
    return jfull_softmax_loss(s, labels)


@pytest.mark.parametrize("b,v,d,bt,vt", [
    (64, 256, 16, 64, 128),
    (70, 300, 32, 32, 128),
    (33, 1000, 8, 64, 256),
    (128, 4096, 64, 128, 512),
    (64, 500, 100, 64, 128),
])
def test_fused_softmax_ce_matches_jax(b, v, d, bt, vt):
    """The five shapes of `test_matches_xla_formulation` (unaligned B and
    V, D = 8 .. 100): loss, du and dt against JAX's kernel and the XLA
    formulation."""
    rng = np.random.default_rng(b * v + d)
    user = rng.normal(size=(b, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, b).astype(np.int32)
    jl, (jdu, jdt) = jax.value_and_grad(
        lambda u, t: jce(u, t, labels, b_tile=bt, v_tile=vt,
                         interpret=True), argnums=(0, 1))(user, table)
    xl, (xdu, xdt) = jax.value_and_grad(
        lambda u, t: _xla(u, t, labels), argnums=(0, 1))(user, table)
    loss, du, dt, _ = _port(lambda u, t, l, _: fused_softmax_ce(u, t, l),
                            user, table, labels)
    assert abs(loss - float(xl)) <= 1e-5 * abs(float(xl))
    assert abs(loss - float(jl)) <= 5e-4 * abs(float(jl))
    for got, want in ((du, jdu), (dt, jdt)):
        _close(got, want)
    for got, want in ((du, xdu), (dt, xdt)):
        _close(got, want, rel=1e-2)
    # the port's own full-scores CE over the same bf16 logits
    s = (torch.from_numpy(user).bfloat16().float()
         @ torch.from_numpy(table).bfloat16().float().T)
    np.testing.assert_allclose(
        float(full_softmax_loss(s, torch.from_numpy(labels))), float(xl),
        rtol=1e-6)


def test_weighted_ce_zero_rows_are_exact_noops():
    rng = np.random.default_rng(7)
    b, v, d = 48, 300, 16
    user = rng.normal(size=(b, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, b).astype(np.int32)
    w = (rng.random(b) * (rng.random(b) > 0.3)).astype(np.float32)
    jl, (jdu, jdt, jdw) = jax.value_and_grad(
        lambda u, t, ww: jce(u, t, labels, weights=ww, b_tile=16,
                             v_tile=128, interpret=True),
        argnums=(0, 1, 2))(user, table, w)
    loss, du, dt, dw = _port(fused_softmax_ce, user, table, labels, w)
    assert abs(loss - float(jl)) <= 5e-4 * abs(float(jl))
    _close(du, jdu)
    _close(dt, jdt)
    np.testing.assert_allclose(dw, np.asarray(jdw), atol=2e-3)
    zero = w == 0
    assert zero.any() and float(np.abs(du[zero]).max()) == 0.0


@pytest.mark.parametrize("case", ["all_160", "all_minus_40"])
def test_extreme_logits(case):
    """All logits 160 over V = 256 (a plain sum of exps overflows): CE =
    log 256 exactly; all logits -40 over an unaligned V = 300 (every real
    logit far below a zero pad): CE = log 300. Both finite, as in JAX."""
    if case == "all_160":
        user = np.full((8, 16), 10.0, np.float32)
        table = np.full((256, 16), 1.0, np.float32)
    else:
        user = np.full((8, 16), 2.0, np.float32)
        table = np.full((300, 16), -1.25, np.float32)
    labels = np.arange(8, dtype=np.int32)
    v = table.shape[0]
    loss, du, dt, _ = _port(lambda u, t, l, _: fused_softmax_ce(u, t, l),
                            user, table, labels)
    np.testing.assert_allclose(loss, np.log(v), rtol=1e-6)
    jl = float(jce(user, table, labels, b_tile=8, v_tile=128,
                   interpret=True))
    np.testing.assert_allclose(loss, jl, rtol=1e-3)
    assert np.isfinite(du).all() and np.isfinite(dt).all()


def test_multinomial_matches_jax_with_empty_row():
    rng = np.random.default_rng(1)
    b, v, d, h = 40, 300, 16, 5
    user = rng.normal(size=(b, d)).astype(np.float32)
    table = rng.normal(size=(v, d)).astype(np.float32)
    pos = rng.integers(0, v, (b, h)).astype(np.int32)
    mask = (0.2 + rng.random((b, h))).astype(np.float32)
    mask *= rng.random((b, h)) > 0.3
    mask[3] = 0.0
    jl, (jdu, jdt, jdm) = jax.value_and_grad(
        lambda u, t, m: jmce(u, t, pos, m, b_tile=16, v_tile=128,
                             interpret=True),
        argnums=(0, 1, 2))(user, table, mask)
    loss, du, dt, dm = _port(fused_multinomial_ce, user, table, pos, mask)
    assert abs(loss - float(jl)) <= 5e-4 * abs(float(jl))
    _close(du, jdu)
    _close(dt, jdt)
    np.testing.assert_allclose(dm, np.asarray(jdm), atol=2e-3)
    assert float(np.abs(du[3]).max()) == 0.0        # empty row: a no-op
    # pos_mask=None counts every slot
    full = float(fused_multinomial_ce(torch.from_numpy(user),
                                      torch.from_numpy(table),
                                      torch.from_numpy(pos)))
    np.testing.assert_allclose(
        full, float(jmce(user, table, pos, b_tile=16, v_tile=128,
                         interpret=True)), rtol=5e-4)


def test_plain_sweeps_do_not_depend_on_the_chunk():
    """The plain versions walk V in chunks (so they run at V = 1M on the
    card); any chunk gives the same lse, du and dt."""
    rng = np.random.default_rng(5)
    user = torch.from_numpy(rng.normal(size=(20, 24)).astype(np.float32))
    table = torch.from_numpy(rng.normal(size=(333, 24)).astype(np.float32))
    u, t = ce_operands(user, table)
    assert u.shape == (20, 32) and t.dtype == torch.bfloat16
    lse = fused_ce_lse_plain(u, t)
    torch.testing.assert_close(fused_ce_lse_plain(u, t, chunk=50), lse)
    scale = torch.tensor(0.5)
    du, dt = fused_ce_bwd_plain(u, t, lse, scale, 24)
    du2, dt2 = fused_ce_bwd_plain(u, t, lse, scale, 24, chunk=64)
    assert du.shape == (20, 24) and dt.shape == (333, 24)
    torch.testing.assert_close(du2, du)
    torch.testing.assert_close(dt2, dt)


@pytest.mark.parametrize("b", [1, 200, 256, 257, 1000, 1024, 1025, 8192])
@pytest.mark.parametrize("v", [1, 63, 100_003, 1_000_000])
@pytest.mark.parametrize("dp", [16, 64, 112, 128])
def test_plan_covers_b_and_every_tile_once(b, v, dp):
    """The kernel's cluster plan on a 132-SM card: clusters of one, two or
    four blocks (the fewest that hold B, four at most), 256 rows a block up
    to a padded depth of 64 and 128 above,
    passes that cover B (the last one not empty), and runs of table tiles,
    one a cluster, that cover every 64-row tile exactly once."""
    plan = fce._plan(b, v, dp, 132)
    assert plan.rows == (256 if dp <= 64 else 128)
    need = -(-b // plan.rows)
    assert plan.cluster in (1, 2, 4)
    assert plan.cluster == 4 or plan.cluster >= need > plan.cluster // 2
    pass_rows = plan.cluster * plan.rows
    assert plan.passes * pass_rows >= b > (plan.passes - 1) * pass_rows
    assert plan.clusters * plan.cluster <= 132
    tiles = -(-v // 64)
    seen = np.zeros(tiles, np.int64)
    for k in range(plan.clusters):
        lo, hi = k * plan.per, min(tiles, (k + 1) * plan.per)
        assert lo < hi                              # no cluster without tiles
        seen[lo:hi] += 1
    assert (seen == 1).all()


def test_cuda_path_never_takes_the_plain_version(monkeypatch, tmp_path):
    """Only a CPU tensor reaches a plain version: any other device goes to
    the kernel path, which raises rather than fall back; a kernel that
    cannot be built raises too."""
    def refuse(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(fce, "fused_ce_lse_plain", refuse)
    monkeypatch.setattr(fce, "fused_ce_bwd_plain", refuse)
    before = dict(fce.launches)
    u = torch.empty((4, 64), device="meta")
    t = torch.empty((300, 64), device="meta")
    labels = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fused_softmax_ce(u, t, labels)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_multinomial_ce(u, t, torch.zeros((4, 3), dtype=torch.int64,
                                               device="meta"))
    with pytest.raises(ValueError, match="D <= 128"):
        fused_softmax_ce(torch.empty((4, 130), device="meta"),
                         torch.empty((300, 130), device="meta"), labels)
    assert fce.launches == before
    # no library and no compiler: building the kernel raises
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    fce._kernel_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            fce._kernel_lib()
    finally:
        fce._kernel_lib.cache_clear()
    assert "fused_ce.cu" in _build.SOURCES.values()


def test_argument_errors():
    with pytest.raises(ValueError, match="user"):
        fused_softmax_ce(torch.zeros(4, 8), torch.zeros(10, 6),
                         torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="id rows"):
        fused_softmax_ce(torch.zeros(4, 8), torch.zeros(10, 8),
                         torch.zeros(3, dtype=torch.int64))
