"""JAX's `jax.random.normal(jax.random.PRNGKey(seed), shape)`, computed in
numpy without JAX.

MIND's capsule routing starts from a fixed draw, ``normal(PRNGKey(17),
(1, K, L))`` (`recbox_tpu/nn/attention.py:153-156`): the routing logits of
every batch. The port cannot call JAX, so it keeps this copy of the draw:

  * the key ``PRNGKey(seed)`` is the pair of words (0, seed);
  * the bits are threefry2x32 (20 rounds) over the flat element index i,
    split into the counter words (i >> 32, i & 0xffffffff), the two output
    words XORed: JAX's bit layout under ``jax_threefry_partitionable``
    (True, JAX's default since 0.5);
  * the uniform on [nextafter(-1, 0), 1) keeps the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, times 2, plus the low end, at
    least the low end: JAX's ``uniform``;
  * the normal is √2 · erfinv(u), erfinv by XLA's single-precision
    polynomial (Giles, two branches at w = -log1p(-u²) = 5), each step of
    the Horner sum fused as XLA's CPU backend fuses it.

Queue C divergence (`ROADMAP.md`): the bits and the uniform equal JAX's bit
for bit; the normal is within a few ulp of JAX's, not always equal,
because XLA computes log1p with its own approximation and numpy with the C
library's (3 ulp at most over K ∈ {2, 3, 4, 8}, L ∈ {1, 10, 50, 200};
`tests/test_torch_multi_interest.py` holds it within 16).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["threefry_bits", "jax_uniform", "jax_normal"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# XLA's ErfInv32 coefficients (w < 5, then w >= 5), highest order first
_W_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
            -4.39150654e-06, 0.00021858087, -0.00125372503,
            -0.00417768164, 0.246640727, 1.50140941)
_W_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
            -0.00367342844, 0.00573950773, -0.0076224613,
            0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(np.uint32(k0) ^ np.uint32(k1) ^ _PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def threefry_bits(seed: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), shape, uint32)``."""
    n = int(np.prod(shape))
    count = np.arange(n, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        a, b = _threefry2x32(0, int(seed) & 0xFFFFFFFF, hi, lo)
    return (a ^ b).reshape(tuple(shape))


def jax_uniform(seed: int, shape: Sequence[int]) -> np.ndarray:
    """The f32 uniform ``jax.random.normal`` transforms: on
    [nextafter(-1, 0), 1)."""
    bits = threefry_bits(seed, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    return np.maximum(lo, floats * np.float32(2.0) + lo)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, np.float32(_W_SMALL[0]), np.float32(_W_LARGE[0]))
    w64 = w.astype(np.float64)
    for cs, cl in zip(_W_SMALL[1:], _W_LARGE[1:]):
        c = np.where(small, np.float32(cs), np.float32(cl)).astype(np.float64)
        # c + p·w rounded once (a fused multiply-add)
        p = (c + p.astype(np.float64) * w64).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max,
                    p * x).astype(np.float32)


def jax_normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), shape, float32)`` (see the module
    docstring for how far it equals JAX's)."""
    u = jax_uniform(seed, shape)
    return (np.float32(np.sqrt(2.0)) * _erfinv32(u)).astype(np.float32)
