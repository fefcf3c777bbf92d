"""The port's matching losses against the JAX package's, on the CPU.

Each loss of `get_matching_loss` (with and without its options) and
`bpr_loss`, on the same fp32 ``y_pred`` (B, 1 + num_negs) drawn with
numpy: the value and the gradient with respect to ``y_pred``, rtol 1e-6
(the gradient's entries also within 1e-6 of its largest: σ(x) - 1 and
its kin lose their low bits to cancellation, one f32 ulp of 1.0 in an
entry of 0.01); `get_ranking_loss`'s names; the
registries' errors for unknown names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.ops import losses as jl
from recbox_tpu_torch.ops import losses as pl_

CASES = [
    ("CosineContrastiveLoss", {}),
    ("CosineContrastiveLoss", {"margin": 0.2}),
    ("CosineContrastiveLoss", {"margin": 0.1, "negative_weight": 0.5}),
    ("MSELoss", {}),
    ("PairwiseLogisticLoss", {}),
    ("PairwiseMarginLoss", {}),
    ("PairwiseMarginLoss", {"margin": 0.3}),
    ("SigmoidCrossEntropyLoss", {}),
    ("SoftmaxCrossEntropyLoss", {}),
]


def _y(seed, b=32, s=5):
    return np.random.default_rng(seed).normal(size=(b, s)).astype(
        np.float32) * 2.0


def _compare(jfn, pfn, *arrays):
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    pv = pfn(*ts)
    pg = torch.autograd.grad(pv, ts)
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-6)
    for a, b in zip(pg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}{sorted(k.items())}" for n, k in CASES])
@pytest.mark.parametrize("s", [2, 5])
def test_matching_loss_matches_jax(name, kw, s):
    y = _y(s, s=s)
    _compare(jl.get_matching_loss(name, **kw),
             pl_.get_matching_loss(name, **kw), y)


def test_bpr_loss_matches_jax():
    rng = np.random.default_rng(3)
    pos = rng.normal(size=64).astype(np.float32)
    neg = rng.normal(size=64).astype(np.float32)
    _compare(jl.bpr_loss, pl_.bpr_loss, pos, neg)
    _compare(lambda a, b: jl.bpr_loss(a, b, gamma=1e-3),
             lambda a, b: pl_.bpr_loss(a, b, gamma=1e-3), pos, neg)


@pytest.mark.parametrize("name", ["binary_crossentropy", "BCE", "logloss",
                                  "mse", "Mean_Squared_Error"])
def test_ranking_loss_names(name):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=16).astype(np.float32)
    labels = (rng.random(16) > 0.5).astype(np.float32)
    _compare(lambda x: jl.get_ranking_loss(name)(x, jnp.asarray(labels)),
             lambda x: pl_.get_ranking_loss(name)(x, torch.tensor(labels)),
             logits)


def test_registry_errors():
    with pytest.raises(NotImplementedError, match="matching loss"):
        pl_.get_matching_loss("BPRLoss")
    with pytest.raises(NotImplementedError, match="ranking loss"):
        pl_.get_ranking_loss("hinge")
    assert sorted(pl_._MATCHING_LOSSES) == sorted(jl._MATCHING_LOSSES)
