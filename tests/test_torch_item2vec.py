"""Item2Vec of the port against the JAX package, on the CPU.

- `build_skipgram_pairs` equals JAX's arrays bit for bit, with and without
  the subsample to ``max_pairs``.
- On JAX's initial params: the pair logits, `sgns_loss` and its gradients
  (rtol 1e-5 / 1e-4), ``user_vector`` over 0-padded histories (an empty
  one included), ``item_vectors``, and one Adam step of `Trainer`.
- The initial draw (normal(0.05) tables) against JAX's by distribution
  (`test_torch_ctr_extended_init._check_draws`).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.models.matching import item2vec as J
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.matching import item2vec as P
from recbox_tpu_torch.training import Trainer, TrainerConfig
from test_torch_ctr_extended_init import _check_draws

RTOL, GTOL, ATOL = 1e-5, 1e-4, 1e-7
N_ITEMS, DIM, B, NEG = 50, 8, 16, 5


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _user_items(seed=0, n_users=12):
    rng = np.random.default_rng(seed)
    return {u: rng.integers(1, N_ITEMS, rng.integers(1, 9)).tolist()
            for u in range(n_users)}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"center": rng.integers(0, N_ITEMS, B).astype(np.int32),
            "context": rng.integers(0, N_ITEMS, B).astype(np.int32),
            "neg": rng.integers(0, N_ITEMS, (B, NEG)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _models(seed=0):
    jm = J.Item2Vec(num_items=N_ITEMS, embedding_dim=DIM)
    jparams = _np(jm.init(jax.random.PRNGKey(seed), _batch())["params"])
    pm = P.Item2Vec(N_ITEMS, DIM, device="cpu")
    pm.load_state_dict(from_jax_params(jparams, pm))
    return jm, jparams, pm


@pytest.mark.parametrize("window,max_pairs,seed", [(2, 200_000, 0),
                                                    (3, 40, 5)])
def test_build_skipgram_pairs_matches_jax(window, max_pairs, seed):
    u2i = _user_items(seed)
    want = J.build_skipgram_pairs(u2i, window, max_pairs, seed)
    got = P.build_skipgram_pairs(u2i, window, max_pairs, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    if max_pairs == 40:
        assert len(got[0]) == 40


def test_pair_logits_loss_and_grads_match_jax():
    jm, jparams, pm = _models()
    batch = _batch(1)
    jpos, jneg = jm.apply({"params": jparams}, batch)
    ppos, pneg = pm(_t(batch))
    np.testing.assert_allclose(ppos.detach().numpy(), np.asarray(jpos),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pneg.detach().numpy(), np.asarray(jneg),
                               rtol=RTOL, atol=ATOL)

    def jloss(p):
        return J.sgns_loss(jm.apply({"params": p}, batch))
    ploss = P.sgns_loss(pm(_t(batch)))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss(jparams)),
                               rtol=RTOL)
    want = from_jax_params(_np(jax.grad(jloss)(jparams)), pm)
    names = [n for n, _ in pm.named_parameters()]
    for n, g in zip(names, torch.autograd.grad(ploss, list(pm.parameters()))):
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GTOL,
                                   atol=GTOL * np.abs(w).max(), err_msg=n)


def test_user_and_item_vectors_match_jax():
    jm, jparams, pm = _models(2)
    hist = np.random.default_rng(3).integers(1, N_ITEMS, (6, 4)).astype(
        np.int32)
    hist[1, 2:] = 0
    hist[4] = 0                                      # an empty history
    want = jm.apply({"params": jparams}, jnp.asarray(hist),
                    method=jm.user_vector)
    got = pm.user_vector(torch.from_numpy(hist))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert not got[4].any()
    np.testing.assert_array_equal(
        pm.item_vectors().detach().numpy(),
        np.asarray(jm.apply({"params": jparams}, method=jm.item_vectors)))


def test_one_adam_step_matches_jax():
    jm, jparams, pm = _models(4)
    batch = _batch(5)
    cfg = dict(learning_rate=1e-2)
    jt = JTrainer(jm, lambda o, b: J.sgns_loss(o), JTrainerConfig(**cfg))
    jt.init(batch)
    jt.params = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                       jparams)
    jt.opt_state = jt.tx.init(jt.params)
    pt = Trainer(pm, lambda o, b: P.sgns_loss(o), TrainerConfig(**cfg),
                 device="cpu")
    np.testing.assert_allclose(float(pt.train_step(dict(batch))),
                               float(jt.train_step(dict(batch))), rtol=RTOL)
    want = from_jax_params(_np(jt.params), pm)
    for key, v in pm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[key].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_initial_draw_matches_jax():
    _check_draws(J.Item2Vec(num_items=N_ITEMS, embedding_dim=DIM),
                 lambda g: P.Item2Vec(N_ITEMS, DIM, generator=g,
                                      device="cpu"), _batch())
