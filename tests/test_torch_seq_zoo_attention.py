"""The port's attention-based sequential models against JAX's, on the CPU:
BERT4Rec (with its cloze path), CORE, LightSANs and FDSA.

The checks, sizes, batch and tolerances are `test_torch_sequential_zoo.py`'s
(its docstring states them). BERT4Rec's cloze: `masked_item_scores` at
rtol 1e-5; `fused_cloze_loss` through B2's plain version against JAX's
kernel in Pallas interpret mode (the JAX package's own CPU route), a third
of the weights zero, the loss within 1e-3 relative and every gradient
within 0.5% of the largest (B2's bounds, `ROADMAP.md` Queue C #7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sequential_zoo import (
    B, DIM, FV, L, V, _batch, _close, _jax, _jmodel, _np_tree, _pmodel, _tb,
    check_adam_step, check_bf16_compute, check_ce_gradients, check_forward,
)
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.ops.fused_ce import fused_softmax_ce

HERE = ("BERT4Rec", "CORE", "LightSANs", "FDSA")


@pytest.mark.parametrize("name", HERE)
def test_forward_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", HERE)
def test_ce_gradients_match_jax(name):
    check_ce_gradients(name)


@pytest.mark.parametrize("name", HERE)
def test_adam_step_matches_jax(name):
    check_adam_step(name)


@pytest.mark.parametrize("name", ("BERT4Rec", "CORE", "FDSA"))
def test_bf16_compute_matches_jax(name):
    check_bf16_compute(name)


def _cloze(seed=5):
    """Two masked positions a row of `_batch`, [MASK] = V, a third of the
    weights zero."""
    batch = _batch(seed)
    seq = batch["item_seq"].copy()
    positions = np.stack([np.full(B, L - 1), np.full(B, L - 2)],
                         axis=1).astype(np.int32)
    labels = np.take_along_axis(seq, positions, axis=1)
    labels = np.where(labels == 0, 1, labels).astype(np.int32)
    seq[:, -2:] = V
    weights = (np.random.default_rng(seed).random((B, 2)) > 0.33).astype(
        np.float32)
    weights[0] = [0.0, 1.0]
    return seq, batch["seq_len"], positions, labels, weights


def test_bert4rec_cloze_matches_jax():
    """`masked_item_scores` at rtol 1e-5; `fused_cloze_loss` (B2's plain
    version) against JAX's (B2 in interpret mode) with zero weights: the
    loss and the gradients of the (V + 1)-row table and the encoder, at
    B2's bounds; the [MASK] row's gradient from the output side is 0, and
    zero-weight rows change nothing."""
    ref = _jax("BERT4Rec")
    jm = _jmodel("BERT4Rec")
    pm = _pmodel("BERT4Rec", ref["params"])
    seq, sl, pos, labels, w = _cloze()
    args = [jnp.asarray(x) for x in (seq, sl, pos)]
    want = np.asarray(jm.apply({"params": ref["params"]}, *args,
                               method=jm.masked_item_scores))
    targs = [torch.from_numpy(x) for x in (seq, sl, pos)]
    with torch.no_grad():
        got = pm.masked_item_scores(*targs)
    assert got.shape == (B, 2, V)
    _close(got, want, 1e-5, 1e-6)

    def jloss(p):
        return jm.apply({"params": p}, *args, jnp.asarray(labels),
                        jnp.asarray(w), method=jm.fused_cloze_loss)

    jl, jg = jax.value_and_grad(jloss)(ref["params"])
    loss = pm.fused_cloze_loss(*targs, torch.from_numpy(labels),
                               torch.from_numpy(w))
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-3 * abs(float(jl))
    expect = from_jax_params(_np_tree(jg), pm)
    named = dict(pm.named_parameters())
    top = max(float(g.abs().max()) for g in expect.values())
    for k, g in expect.items():
        _close(named[k].grad, g.numpy(), 0.0, 5e-3 * top / max(
            float(g.abs().max()), 1e-30))
    # the [MASK] row enters only as an input token: with the inputs
    # detached, B2's side leaves it exactly 0
    h = pm._gathered(*targs).detach().reshape(-1, DIM).requires_grad_(True)
    table = pm.emb_item.detach().clone().requires_grad_(True)
    fused_softmax_ce(h, table[:V], torch.from_numpy(labels).reshape(-1),
                     torch.from_numpy(w).reshape(-1)).backward()
    assert float(table.grad[V].abs().max()) == 0.0
    dead = torch.from_numpy(w.reshape(-1) == 0)
    assert float(h.grad[dead].abs().max()) == 0.0


def test_fdsa_reads_its_feature_column():
    """With ``feature_vocab`` the feature stream embeds ``feat_seq``: a
    change of the column changes the user vector, and a batch without it
    raises KeyError."""
    ref = _jax("FDSA")
    pm = _pmodel("FDSA", ref["params"])
    tb = _tb(_batch(0))
    with torch.no_grad():
        a = pm.user_tower(tb)
        tb2 = dict(tb, feat_seq=torch.where(tb["feat_seq"] > 0,
                                            FV - tb["feat_seq"], 0))
        assert float((pm.user_tower(tb2) - a).abs().max()) > 1e-4
        del tb2["feat_seq"]
        with pytest.raises(KeyError):
            pm.user_tower(tb2)
