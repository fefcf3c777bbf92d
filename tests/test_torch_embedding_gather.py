"""Port of the fused sequence pool (B6 `embedding_gather`) against the JAX
package, on the CPU.

The port runs the kernel's plain PyTorch version here (the CUDA kernel is
held against it on the card by `chip_smoke.py`). JAX's kernel runs in
Pallas interpret mode where it runs (D % 128 == 0, B % 8 == 0), its XLA
gather + pool elsewhere. Tolerance: rtol 1e-5, atol 1e-6 (the sums over L
are taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.ops.pallas.embedding_gather import (
    _pallas_pool, seq_embedding_pool_xla,
)
from recbox_tpu_torch.ops import embedding_gather as pool_mod
from recbox_tpu_torch.ops import seq_embedding_pool


def _inputs(seed, v, d, b, length, pad_id):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, length)).astype(np.int32)
    ids[0, :4] = pad_id          # a partly padded row
    ids[3, :] = pad_id           # a row of pads
    ids[rng.random((b, length)) < 0.2] = pad_id
    return table, ids


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_pool_matches_jax_kernel_d128(mode):
    """D=128, B=16: JAX's own kernel in interpret mode."""
    table, ids = _inputs(31, 200, 128, 16, 7, 199)
    want = _pallas_pool(jnp.asarray(table), jnp.asarray(ids), 199, mode, True)
    got = seq_embedding_pool(torch.from_numpy(table), torch.from_numpy(ids),
                             pad_id=199, mode=mode)
    assert got.dtype == torch.float32 and got.shape == (16, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), 0.0)


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_pool_matches_jax_xla_d64(mode):
    """D=64 (YoutubeDNN's history width), B=10, pad id 0: JAX's default XLA
    path, which its kernel cannot take."""
    table, ids = _inputs(32, 50, 64, 10, 9, 0)
    want = seq_embedding_pool_xla(jnp.asarray(table), jnp.asarray(ids), 0,
                                  mode)
    got = seq_embedding_pool(torch.from_numpy(table), torch.from_numpy(ids),
                             pad_id=0, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_pool_pad_id_outside_table_and_bf16():
    """A pad id past the table is never read (JAX's gather would fill it
    with NaN before the mask); a bf16 table pools in f32 and returns bf16,
    the table's dtype, as JAX's default path does."""
    table, ids = _inputs(33, 64, 32, 8, 5, 64)
    got = seq_embedding_pool(torch.from_numpy(table), torch.from_numpy(ids),
                             pad_id=64, mode="mean")
    mask = ids != 64
    want = (table[np.where(mask, ids, 0)] * mask[..., None]).sum(1)
    want /= np.maximum(mask.sum(1, keepdims=True), 1e-12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    tb = torch.from_numpy(table).to(torch.bfloat16)
    got16 = seq_embedding_pool(tb, torch.from_numpy(ids), pad_id=64)
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(
        got16, seq_embedding_pool(tb.float(), torch.from_numpy(ids),
                                  pad_id=64).to(torch.bfloat16))
    with pytest.raises(ValueError, match="mode"):
        seq_embedding_pool(tb, torch.from_numpy(ids), pad_id=64, mode="max")


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_pool_ids_out_of_range_match_jax_xla(mode):
    """Ids in [-V, 0) count from the end and a row holding an id past the
    table is NaN, in the port as in JAX's gather; other rows are untouched."""
    table, ids = _inputs(34, 40, 16, 6, 5, 7)
    ids[1, 2] = -1
    ids[2, 0] = -40
    ids[4, 3] = 40
    ids[5, 1] = 1000
    want = np.asarray(seq_embedding_pool_xla(jnp.asarray(table),
                                             jnp.asarray(ids), 7, mode))
    got = seq_embedding_pool(torch.from_numpy(table), torch.from_numpy(ids),
                             pad_id=7, mode=mode).numpy()
    assert np.isnan(got[4:]).all() and np.isfinite(got[:4]).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pool_non_cpu_tensor_never_takes_plain_version():
    before = dict(pool_mod.launches)
    table = torch.empty((100, 64), device="meta")
    ids = torch.empty((8, 5), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        seq_embedding_pool(table, ids, pad_id=0)
    assert pool_mod.launches == before
