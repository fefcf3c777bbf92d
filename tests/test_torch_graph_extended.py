"""SGL, NCL, DGCF, SpectralCF, GCMC and LINE of the port against the JAX
package, on the CPU.

- `kmeans_prototypes` equals JAX's array for array (numpy, draw for draw);
  `infonce` / `infonce_all` values and gradients.
- Each model on JAX's initial params (moved by `interop.from_jax_params`,
  every parameter filled): the training scores of a `MatchingLoader`
  batch, both towers, the BPR loss's gradients (rtol 1e-4, or 1e-4 of the
  model's largest gradient entry: the hops sum in ``index_add_``'s order)
  and one Adam step of `Trainer.train_step`.
- SGL's ``ssl_loss`` on two given edge masks (JAX's
  ``jax.random.bernoulli`` returns the same masks), NCL's
  ``structural_loss`` and ``prototype_loss`` on `kmeans_prototypes`'
  centers: values and gradients.
- The initial draw of each model (GCMC's orthogonal ``decoder_q``
  included) against JAX's over eight seeds, by distribution
  (`test_torch_ctr_extended_init._check_draws`).
- SGL's masks come from the trainer's dropout generator.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.models.matching import graph as jgraph
from recbox_tpu.models.matching import graph_extended as J
from recbox_tpu.ops import get_matching_loss as jget_matching_loss
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.matching import graph_extended as P
from recbox_tpu_torch.ops.losses import get_matching_loss
from recbox_tpu_torch.training import Trainer, TrainerConfig
from test_torch_ctr_extended_init import _check_draws
from test_torch_graph import (
    ATOL, DIM, N_ITEMS, N_USERS, RTOL, _batch, _data, _maps, _t,
)

GTOL = 1e-4
MODELS = {
    "SGL": dict(ssl_tau=0.3, drop_ratio=0.2),
    "NCL": dict(ssl_tau=0.2, hyper_layers=1),
    "DGCF": dict(n_intents=2, n_routing=2),
    "SpectralCF": {},
    "GCMC": dict(hidden_dim=6),
    "LINE": dict(order=2),
}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _edges(data):
    return jgraph.build_norm_edges(data["user_id"], data["item_id"],
                                   N_USERS, N_ITEMS)


def _models(name, seed=0):
    jfm, pfm = _maps()
    data = _data(seed)
    eu, ei, c = _edges(data)
    common = dict(embedding_dim=DIM, num_users=N_USERS, num_items=N_ITEMS,
                  n_layers=2, **MODELS[name])
    jm = getattr(J, name)(feature_map=jfm, edge_users=tuple(eu.tolist()),
                          edge_items=tuple(ei.tolist()),
                          edge_coefs=tuple(c.tolist()), **common)
    jb, pb = _batch(jfm, pfm, data)
    jparams = _np(jm.init(jax.random.PRNGKey(seed), jb)["params"])
    pm = getattr(P, name)(pfm, edge_users=eu, edge_items=ei, edge_coefs=c,
                          device="cpu",
                          generator=torch.Generator().manual_seed(seed + 9),
                          **common)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    state = from_jax_params(jparams, pm)
    assert set(state) == set(before)
    pm.load_state_dict(state)
    for key, v in pm.state_dict().items():
        assert not torch.equal(v, before[key]) \
            or bool((v == v.flatten()[0]).all()), key
    return jm, jparams, pm, jb, pb


def _check_grads(pm, jgrads, ploss):
    want = from_jax_params(_np(jgrads), pm)
    params = list(pm.named_parameters())
    grads = torch.autograd.grad(ploss, [p for _, p in params],
                                allow_unused=True)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for (n, p), g in zip(params, grads):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=GTOL,
                                   atol=GTOL * top, err_msg=n)


def test_kmeans_prototypes_matches_jax():
    rng = np.random.default_rng(2)
    emb = np.concatenate([rng.normal(m, 0.3, (40, 5)) for m in (-2, 0, 3)]
                         ).astype(np.float32)
    for k, seed in ((3, 0), (5, 4)):
        for a, b in zip(J.kmeans_prototypes(emb, k, 10, seed),
                        P.kmeans_prototypes(emb, k, 10, seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    same = np.ones((6, 3), np.float32)             # the uniform fallback
    for a, b in zip(J.kmeans_prototypes(same, 3), P.kmeans_prototypes(same, 3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["infonce", "infonce_all"])
def test_infonce_matches_jax(which):
    rng = np.random.default_rng(5)
    a, b, c = (rng.normal(size=s).astype(np.float32)
               for s in ((7, 4), (7, 4), (11, 4)))
    args = (a, b) if which == "infonce" else (a, b, c)
    jf = getattr(J, which)
    want, jg = jax.value_and_grad(lambda *x: jf(*x, tau=0.3),
                                  argnums=tuple(range(len(args))))(*args)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in args]
    got = getattr(P, which)(*ts, tau=0.3)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    for t, g in zip(torch.autograd.grad(got, ts), jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(g), rtol=GTOL,
                                   atol=GTOL * np.abs(g).max())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_towers_and_grads_match_jax(name):
    jm, jparams, pm, jb, pb = _models(name)
    want = np.asarray(jm.apply({"params": jparams}, jb))
    got = pm(_t(jb))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    users = {"user_id": np.arange(N_USERS, dtype=np.int32)}
    items = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    for method, b in (("user_tower", users), ("item_tower", items)):
        w = np.asarray(jm.apply({"params": jparams}, b,
                                method=getattr(jm, method)))
        np.testing.assert_allclose(
            getattr(pm, method)(_t(b)).detach().numpy(), w, rtol=RTOL,
            atol=RTOL * np.abs(w).max(), err_msg=method)
    loss = jget_matching_loss("PairwiseLogisticLoss")
    jgrads = jax.grad(lambda p: loss(jm.apply({"params": p}, jb)))(jparams)
    _check_grads(pm, jgrads,
                 get_matching_loss("PairwiseLogisticLoss")(pm(_t(pb))))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_adam_step_matches_jax(name):
    jm, jparams, pm, jb, pb = _models(name)
    cfg = dict(learning_rate=1e-2)
    jt = JTrainer(jm, lambda o, b: jget_matching_loss(
        "PairwiseLogisticLoss")(o), JTrainerConfig(**cfg))
    jt.init(jb)
    jt.params = jax.tree_util.tree_map(jnp.asarray, jparams)
    jt.opt_state = jt.tx.init(jt.params)
    pt = Trainer(pm, lambda o, b: get_matching_loss(
        "PairwiseLogisticLoss")(o), TrainerConfig(**cfg), device="cpu")
    loss = jget_matching_loss("PairwiseLogisticLoss")
    jgrads = from_jax_params(_np(jax.grad(
        lambda p: loss(jm.apply({"params": p}, jb)))(jparams)), pm)
    top = max(float(np.abs(g.numpy()).max()) for g in jgrads.values())
    init = {k: v.clone() for k, v in pm.state_dict().items()}
    np.testing.assert_allclose(float(pt.train_step(dict(pb))),
                               float(jt.train_step(dict(jb))), rtol=RTOL)
    want = from_jax_params(_np(jt.params), pm)
    for key, v in pm.state_dict().items():
        # Adam's first step is ±lr · g / (|g| + eps): where the gradient is
        # rounding noise (below 1e-4 of the largest; GCMC's item-side bias
        # shifts a row's scores alike) its sign is either package's, and
        # the step is held to its size alone
        sure = np.abs(jgrads[key].numpy()) > GTOL * top
        np.testing.assert_allclose(v.numpy()[sure], want[key].numpy()[sure],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
        step = np.abs(v.numpy() - init[key].numpy())
        assert (step <= cfg["learning_rate"] * (1 + 1e-5)).all(), key


def test_sgl_ssl_loss_on_given_masks_matches_jax(monkeypatch):
    jm, jparams, pm, jb, pb = _models("SGL")
    rng = np.random.default_rng(6)
    masks = [rng.random(len(pm.edge_users)) < 0.8 for _ in range(2)]
    queue = list(masks)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(queue.pop(0)))

    def jloss(p):
        queue[:] = list(masks)
        return jm.apply({"params": p}, jb, method=jm.ssl_loss,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    ploss = pm.ssl_loss(_t(pb), masks=tuple(torch.from_numpy(m)
                                            for m in masks))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss(jparams)),
                               rtol=RTOL)
    _check_grads(pm, jax.grad(jloss)(jparams), ploss)


def test_sgl_masks_come_from_the_dropout_generator():
    _, _, pm, _, pb = _models("SGL")
    t = Trainer(pm, lambda o, b: o.sum(), TrainerConfig(seed=5),
                device="cpu")
    t.init(pb)
    assert pm.edge_drop.generator is t.dropout_generator
    a = pm.ssl_loss(_t(pb))
    b = pm.ssl_loss(_t(pb))
    assert not torch.equal(a, b)          # two draws, two pairs of views


@pytest.mark.parametrize("term", ["structural", "prototype"])
def test_ncl_losses_match_jax(term):
    jm, jparams, pm, jb, pb = _models("NCL")
    if term == "structural":
        def jloss(p):
            return jm.apply({"params": p}, jb, method=jm.structural_loss)
        ploss = pm.structural_loss(_t(pb))
    else:
        uc, ua = P.kmeans_prototypes(jparams["emb_user"], 3, seed=1)
        ic, ia = P.kmeans_prototypes(jparams["emb_item"], 4, seed=2)

        def jloss(p):
            return jm.apply({"params": p}, jb, uc, ic, ua, ia,
                            method=jm.prototype_loss)
        ploss = pm.prototype_loss(_t(pb), uc, ic, ua, ia)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss(jparams)),
                               rtol=RTOL)
    _check_grads(pm, jax.grad(jloss)(jparams), ploss)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_initial_draw_matches_jax(name):
    jfm, pfm = _maps()
    data = _data(0)
    eu, ei, c = _edges(data)
    common = dict(embedding_dim=DIM, num_users=N_USERS, num_items=N_ITEMS,
                  n_layers=2, **MODELS[name])
    jm = getattr(J, name)(feature_map=jfm, edge_users=tuple(eu.tolist()),
                          edge_items=tuple(ei.tolist()),
                          edge_coefs=tuple(c.tolist()), **common)
    jb, _ = _batch(jfm, pfm, data)
    _check_draws(jm, lambda g: getattr(P, name)(
        pfm, edge_users=eu, edge_items=ei, edge_coefs=c, device="cpu",
        generator=g, **common), jb)
    if name == "GCMC":
        q = P.GCMC(pfm, edge_users=eu, edge_items=ei, edge_coefs=c,
                   device="cpu", **common).decoder_q.detach()
        torch.testing.assert_close(q @ q.T, torch.eye(q.shape[0]),
                                   atol=1e-5, rtol=0)
