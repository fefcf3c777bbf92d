"""MultiVAE, MacridVAE, RecVAE, CDAE, RaCT and `RecVAETrainer` of the port
against the JAX package, on the CPU.

The random streams cannot match (Philox against threefry), so the
'reparam' draws are given: JAX's ``jax.random.normal`` /
``jax.random.bernoulli`` and the port's `nn.core.Reparam` are patched to
return the same numpy noise of each shape, and the input dropout is 0 in
the training-mode checks. On JAX's initial params (moved by
`interop.from_jax_params`, every parameter filled):

- the eval-mode logits and per-user KL (JAX's sown ``intermediates``);
- the training losses (`multivae_loss` / ``elbo_loss``, MacridVAE's,
  `cdae_loss`, `recvae_loss` with the composite prior) and their
  gradients, rtol 1e-5 / 1e-4;
- one Adam step of `Trainer` on ``elbo_loss`` and on `cdae_loss`;
- `RecVAETrainer.fit`: the batch order of ``default_rng(seed)``, the two
  phases' Adams, the prior's refresh, against JAX's trainer;
- RaCT's critic and `ract_critic_features`;
- `build_history_matrix` bit for bit.

The trainer hands a model's `Reparam` a generator of its own, seeded from
``TrainerConfig.seed + REPARAM_SEED_OFFSET``; `train_steps_fused` on the
CPU equals K `train_step` calls bit for bit with both streams drawing.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.models.matching import autoencoder as J
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.recvae import RecVAETrainer as JRecVAETrainer
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.matching import autoencoder as P
from recbox_tpu_torch.nn.core import Dropout, Reparam
from recbox_tpu_torch.training import Trainer, TrainerConfig
from recbox_tpu_torch.training.recvae import RecVAETrainer
from recbox_tpu_torch.training.trainer import REPARAM_SEED_OFFSET

RTOL, GTOL, ATOL = 1e-5, 1e-4, 1e-7
N_USERS, N_ITEMS, B = 24, 30, 8


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _history(seed=0, n=B):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, N_ITEMS)) < 0.2).astype(np.float32)
    x[:, 0] = 1.0                                   # no empty row
    return x


def _noise(shape, kind="normal"):
    """The same noise of each shape for both packages."""
    rng = np.random.default_rng(abs(hash(tuple(shape))) % 2**32)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    return rng.random(shape) < 0.6


@pytest.fixture
def given_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k:
                        jnp.asarray(_noise(tuple(shape))))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape:
                        jnp.asarray(_noise(tuple(shape), "keep")))
    monkeypatch.setattr(Reparam, "normal", lambda self, shape, device:
                        torch.from_numpy(_noise(tuple(shape))).to(device))
    monkeypatch.setattr(Reparam, "keep", lambda self, p, shape, device:
                        torch.from_numpy(_noise(tuple(shape),
                                                "keep")).to(device))


MODELS = {
    "MultiVAE": dict(num_items=N_ITEMS, hidden_units=(12,), latent_dim=6,
                     dropout=0.0),
    "MacridVAE": dict(num_items=N_ITEMS, latent_dim=6, k_factors=3,
                      dropout=0.0),
    "RecVAE": dict(num_items=N_ITEMS, hidden_dim=12, latent_dim=6,
                   n_enc_layers=3, dropout=0.0),
    "CDAE": dict(num_users=N_USERS, num_items=N_ITEMS, hidden_dim=10,
                 corruption=0.4),
    "RaCT": dict(num_items=N_ITEMS, hidden_units=(12,), latent_dim=6,
                 dropout=0.0, critic_hidden=(8, 4)),
}


def _batch(seed=0):
    return {"history": _history(seed),
            "user_id": np.arange(B, dtype=np.int32) % N_USERS}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _models(name, seed=0):
    jm = getattr(J, name)(**MODELS[name])
    batch = _batch(seed)
    rngs = {"params": jax.random.PRNGKey(seed),
            "dropout": jax.random.PRNGKey(1), "reparam": jax.random.PRNGKey(2)}
    kw = {"method": jm.forward_with_latents} if name == "RecVAE" else {}
    jparams = _np(jm.init(rngs, batch, **kw)["params"])
    if name == "RaCT":           # flax makes the critic on its first call
        critic = _np(jm.init(jax.random.PRNGKey(3), jnp.ones((B, 3)),
                             method=jm.critic_score)["params"])
        jparams = {**critic, **jparams}
    pm = getattr(P, name)(**MODELS[name], device="cpu",
                          generator=torch.Generator().manual_seed(seed + 9))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    state = from_jax_params(jparams, pm)
    assert set(state) == set(before)
    pm.load_state_dict(state)
    for key, v in pm.state_dict().items():
        # every drawn entry comes from JAX (a constant init, a zero bias or
        # a LayerNorm scale, is the same in both)
        assert not torch.equal(v, before[key]) \
            or bool((v == v.flatten()[0]).all()), key
    return jm, jparams, pm, batch


def _check_grads(pm, jgrads, ploss):
    want = from_jax_params(_np(jgrads), pm)
    params = [(n, p) for n, p in pm.named_parameters()]
    grads = torch.autograd.grad(ploss, [p for _, p in params],
                                allow_unused=True)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for (n, p), g in zip(params, grads):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=GTOL,
                                   atol=GTOL * top, err_msg=n)


def test_build_history_matrix_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.integers(0, N_USERS, 100)
    i = rng.integers(0, N_ITEMS, 100)
    want = J.build_history_matrix(u, i, N_USERS, N_ITEMS)
    got = P.build_history_matrix(u, i, N_USERS, N_ITEMS)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_logits_match_jax(name):
    jm, jparams, pm, batch = _models(name)
    pm.eval()
    want, state = jm.apply({"params": jparams}, batch,
                           mutable=["intermediates"])
    got = pm(_t(batch))
    # an entry near 0 (a cancellation in the last layer) within 1e-5 of
    # the logits' scale
    atol = RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=atol)
    np.testing.assert_allclose(
        pm.full_scores(_t(batch)).detach().numpy(), np.asarray(want),
        rtol=RTOL, atol=atol)
    if name in ("MultiVAE", "MacridVAE"):
        kl = np.asarray(state["intermediates"]["kl"][0])
        np.testing.assert_allclose(
            pm.forward_with_kl(_t(batch))[1].detach().numpy(), kl,
            rtol=RTOL, atol=ATOL)


def _jax_loss(name, jm, batch):
    """The training loss of ``name`` as a function of JAX's params."""
    if name in ("MultiVAE", "RaCT"):
        def loss(p):
            if name == "RaCT":
                p = {"params": {"actor": p["actor"]}}
                logits, st = jm.apply(p, batch, train=True,
                                      rngs={"dropout": jax.random.PRNGKey(0),
                                            "reparam": jax.random.PRNGKey(0)},
                                      mutable=["intermediates"])
                kl = st["intermediates"]["actor"]["kl"][0]
                return J.multivae_loss(logits, batch, kl)
            return jm.apply({"params": p}, batch, 0.3, method=jm.elbo_loss,
                            rngs={"dropout": jax.random.PRNGKey(0),
                                  "reparam": jax.random.PRNGKey(0)})
        return loss
    if name == "MacridVAE":
        def loss(p):
            logits, st = jm.apply({"params": p}, batch, train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0),
                                        "reparam": jax.random.PRNGKey(0)},
                                  mutable=["intermediates"])
            return J.multivae_loss(logits, batch,
                                   st["intermediates"]["kl"][0])
        return loss
    if name == "CDAE":
        def loss(p):
            return J.cdae_loss(jm.apply(
                {"params": p}, batch, train=True,
                rngs={"reparam": jax.random.PRNGKey(0)}), batch)
        return loss

    def loss(p):            # RecVAE, the prior on a perturbed copy
        logits, mu, logvar, z = jm.apply(
            {"params": p}, batch, train=True,
            rngs={"dropout": jax.random.PRNGKey(0),
                  "reparam": jax.random.PRNGKey(0)},
            method=jm.forward_with_latents)
        old = jax.tree_util.tree_map(
            lambda a: jax.lax.stop_gradient(a) * 0.9, p)
        prior = jm.apply({"params": old}, batch, z,
                         method=jm.composite_prior_logpdf)
        return J.recvae_loss(logits, mu, logvar, z, prior, batch,
                             gamma=jm.gamma, beta=jm.beta)
    return loss


def _port_loss(name, pm, batch):
    pm.train()
    tb = _t(batch)
    if name == "MultiVAE":
        return pm.elbo_loss(tb, 0.3)
    if name in ("MacridVAE", "RaCT"):
        logits, kl = (pm.actor if name == "RaCT" else pm).forward_with_kl(tb)
        return P.multivae_loss(logits, tb, kl)
    if name == "CDAE":
        return P.cdae_loss(pm(tb), tb)
    logits, mu, logvar, z = pm.forward_with_latents(tb)
    old = P.RecVAE(**MODELS["RecVAE"], device="cpu")
    with torch.no_grad():
        for dst, src in zip(old.parameters(), pm.parameters()):
            dst.copy_(src * 0.9)
    prior = old.composite_prior_logpdf(tb, z)
    return P.recvae_loss(logits, mu, logvar, z, prior, tb, gamma=pm.gamma,
                         beta=pm.beta)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_training_loss_and_grads_match_jax(name, given_noise):
    jm, jparams, pm, batch = _models(name)
    jloss = _jax_loss(name, jm, batch)
    ploss = _port_loss(name, pm, batch)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss(jparams)),
                               rtol=RTOL)
    _check_grads(pm, jax.grad(jloss)(jparams), ploss)


@pytest.mark.parametrize("name", ["MultiVAE", "CDAE"])
def test_one_adam_step_matches_jax(name, given_noise):
    jm, jparams, pm, batch = _models(name)
    cfg = dict(learning_rate=1e-2)
    if name == "MultiVAE":
        jt = JTrainer(jm, lambda o, b: o, JTrainerConfig(**cfg),
                      train_method="elbo_loss")
        pt = Trainer(pm, lambda o, b: o, TrainerConfig(**cfg), device="cpu",
                     train_method="elbo_loss")
    else:
        jt = JTrainer(jm, lambda o, b: J.cdae_loss(o, b),
                      JTrainerConfig(**cfg))
        pt = Trainer(pm, lambda o, b: P.cdae_loss(o, b),
                     TrainerConfig(**cfg), device="cpu")
    jt.init(batch)
    jt.params = jax.tree_util.tree_map(jnp.asarray, jparams)
    jt.opt_state = jt.tx.init(jt.params)
    np.testing.assert_allclose(float(pt.train_step(dict(batch))),
                               float(jt.train_step(dict(batch))), rtol=RTOL)
    want = from_jax_params(_np(jt.params), pm)
    for key, v in pm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[key].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_recvae_trainer_matches_jax(given_noise):
    history = _history(5, n=20)
    jm = J.RecVAE(**MODELS["RecVAE"])
    jt = JRecVAETrainer(jm, learning_rate=1e-2, n_enc_epochs=2,
                        n_dec_epochs=1, seed=3)
    jt._init({"history": history[:6]})
    init = _np(jt.params)
    pm = P.RecVAE(**MODELS["RecVAE"], device="cpu")
    pm.load_state_dict(from_jax_params(init, pm))
    pt = RecVAETrainer(pm, learning_rate=1e-2, n_enc_epochs=2,
                       n_dec_epochs=1, seed=3, device="cpu")
    # batch 6 of 20 rows: three batches a sweep, the tail dropped
    jt.fit(history, epochs=2, batch_size=6)
    pt.fit(history, epochs=2, batch_size=6)
    want = from_jax_params(_np(jt.params), pm)
    for key, v in pm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    old = from_jax_params(_np(jt.old_params), pm)
    for key, v in pt.old_model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), old[key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    # the prior is refreshed after the encoder sweeps: its decoder is the
    # one before the decoder sweep
    assert not torch.equal(pt.old_model.dec.weight, pm.dec.weight)
    np.testing.assert_allclose(pt.scores(history[:4]),
                               np.asarray(jt.scores(history[:4])),
                               rtol=1e-4, atol=1e-5)


def test_recvae_phases_leave_the_other_side_alone():
    pm = P.RecVAE(**MODELS["RecVAE"], device="cpu")
    pt = RecVAETrainer(pm, n_enc_epochs=1, n_dec_epochs=0, seed=1,
                       device="cpu")
    dec = pm.dec.weight.detach().clone()
    enc = pm.enc_in.weight.detach().clone()
    pt.fit(_history(2, n=10), epochs=1, batch_size=5)
    assert torch.equal(pm.dec.weight, dec)
    assert not torch.equal(pm.enc_in.weight, enc)
    assert int(pt._opts[True].count) == 0 and int(pt._opts[False].count) == 2


def test_ract_critic_matches_jax():
    jm, jparams, pm, batch = _models("RaCT")
    feats = np.random.default_rng(3).normal(size=(B, 3)).astype(np.float32)
    want = jm.apply({"params": jparams}, jnp.asarray(feats),
                    method=jm.critic_score)
    got = pm.critic_score(torch.from_numpy(feats))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    logits = np.random.default_rng(4).normal(size=(B, N_ITEMS)).astype(
        np.float32)
    kl = np.random.default_rng(5).random(B).astype(np.float32)
    np.testing.assert_allclose(
        P.ract_critic_features(torch.from_numpy(logits), _t(batch),
                               torch.from_numpy(kl)).numpy(),
        np.asarray(J.ract_critic_features(jnp.asarray(logits), batch,
                                          jnp.asarray(kl))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        P.log_norm_pdf(torch.from_numpy(logits), 0.5, 1.5).numpy(),
        np.asarray(J.log_norm_pdf(jnp.asarray(logits), 0.5, 1.5)),
        rtol=RTOL, atol=ATOL)


def test_trainer_hands_out_the_reparam_generator():
    pm = P.MultiVAE(**dict(MODELS["MultiVAE"], dropout=0.3), device="cpu")
    t = Trainer(pm, lambda o, b: o, TrainerConfig(seed=7), device="cpu",
                train_method="elbo_loss")
    t.init(_batch())
    assert pm.reparam.generator is t.reparam_generator
    assert pm.drop.generator is t.dropout_generator
    assert t.reparam_generator.initial_seed() == 7 + REPARAM_SEED_OFFSET
    assert t.dropout_generator.initial_seed() == 7


def test_trainer_makes_no_reparam_generator_without_a_reparam():
    # only a model with a Reparam draws from the stream, so only its
    # trainer makes the generator (and a captured graph registers it)
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), Dropout(0.5))
    t = Trainer(model, lambda o, b: o.sum(), TrainerConfig(seed=7),
                device="cpu")
    t.init(_batch())
    assert t.reparam_generator is None
    assert model[1].generator is t.dropout_generator


@pytest.mark.parametrize("name", ["MultiVAE", "CDAE"])
def test_train_steps_fused_equals_k_steps_on_cpu(name):
    batches = [_batch(s) for s in range(3)]
    trainers = []
    for _ in range(2):
        kw = dict(MODELS[name])
        if name == "MultiVAE":
            kw["dropout"] = 0.3
        m = getattr(P, name)(**kw, device="cpu",
                             generator=torch.Generator().manual_seed(4))
        if name == "MultiVAE":
            trainers.append(Trainer(m, lambda o, b: o, TrainerConfig(seed=3),
                                    device="cpu", train_method="elbo_loss"))
        else:
            trainers.append(Trainer(m, lambda o, b: P.cdae_loss(o, b),
                                    TrainerConfig(seed=3), device="cpu"))
    fused = trainers[0].train_steps_fused(
        {k: np.stack([b[k] for b in batches]) for k in batches[0]})
    eager = torch.stack([trainers[1].train_step(b) for b in batches])
    assert torch.equal(fused, eager)
    for (n, a), b in zip(trainers[0].model.state_dict().items(),
                         trainers[1].model.state_dict().values()):
        assert torch.equal(a, b), n
