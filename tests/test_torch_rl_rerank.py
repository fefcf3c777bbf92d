"""The port's RL rerankers and their losses against the JAX package's, on
the CPU.

EGREvaluator, EGRDiscriminator and PPOReranker get the flax model's params
(`interop.from_jax_params`) and the same numpy lists: full, post-padded,
pre-padded (the valid run starts late) and a list with one valid slot.
Compared: the evaluator's scores at every slot, padded ones included, and
`list_value`; the discriminator's logits; PPO's greedy scores and
`evaluate_actions` on a given permutation (log-probs, entropies, value);
the three losses and their gradients; one Adam step of a PPO update.
`rollout` draws from a torch generator (not JAX's stream): it must give a
permutation with the valid slots first, log-probs equal to
`evaluate_actions` on it, and a first pick distributed as the softmax of
the first step's logits. `run_rerank_experiment` runs EGR, EGREvaluator
and PPOReranker paired with JAX's (the JAX run's initial params), and so
does `run_cascade_experiment` with EGR as its stage 3; EGRDiscriminator's
(B,) logit against (B, N) labels raises in both.

Tolerances: f32 forwards rtol 1e-5 (atol 1e-6; the GRUs sum in other
orders); the losses and every gradient rtol 1e-5 / atol 1e-6, the PPO
step's parameters rtol 1e-5 / atol 1e-6; the paired experiments' metrics
atol 1e-6 (the cascade's 1e-5, `test_torch_cascade.py`'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from recbox_tpu.models.reranking import rl as J
from recbox_tpu.quick_start import run_rerank_experiment as jrun
from recbox_tpu_torch import quick_start as qs
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.reranking import rl as P
from recbox_tpu_torch.training.trainer import TrainerConfig, _make_optimizer
from test_torch_reranking import _np_tree, load_inits, record_jax_inits

B, N, D, DM = 4, 6, 5, 8


def _lists(seed):
    """Rows: full, post-padded (3 valid), pre-padded (valid slots 2..5),
    one valid slot (at 4)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[0] = True
    mask[1, :3] = True
    mask[2, 2:] = True
    mask[3, 4] = True
    labels = (rng.random((B, N)) < 0.5).astype(np.float32) * mask
    return feats, mask, labels


def _pair(name, **kw):
    feats, mask, _ = _lists(0)
    jm = getattr(J, name)(d_model=DM, **kw)
    params = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(feats),
                              jnp.asarray(mask))["params"])
    pm = getattr(P, name)(D, d_model=DM, device="cpu", **kw)
    pm.load_state_dict(from_jax_params(params, pm))
    return jm, params, pm


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_egr_evaluator_scores_every_slot_and_list_value():
    jm, params, pm = _pair("EGREvaluator")
    feats, mask, _ = _lists(1)
    tf, tm = torch.from_numpy(feats), torch.from_numpy(mask)
    want = jm.apply({"params": params}, feats, mask)
    got = pm(tf, tm)
    _close(got, want)                       # padded slots included
    _close(pm.list_value(tf, tm),
           jm.apply({"params": params}, feats, mask,
                    method=jm.list_value))
    # a valid slot's score reads no padded slot: the pre-padded row scored
    # alone over its valid run
    alone = pm(tf[2:3, 2:], tm[2:3, 2:])
    _close(got[2, 2:], alone[0], atol=2e-6)


def test_egr_discriminator_logits():
    jm, params, pm = _pair("EGRDiscriminator", hidden_units=(8, 4))
    feats, mask, _ = _lists(2)
    got = pm(torch.from_numpy(feats), torch.from_numpy(mask))
    assert got.shape == (B,)
    _close(got, jm.apply({"params": params}, feats, mask))


def _perm(seed):
    """A permutation with each row's valid slots first."""
    _, mask, _ = _lists(0)
    rng = np.random.default_rng(seed)
    rows = []
    for m in mask:
        valid = rng.permutation(np.flatnonzero(m))
        rest = rng.permutation(np.flatnonzero(~m))
        rows.append(np.concatenate([valid, rest]))
    return np.stack(rows).astype(np.int32)


def test_ppo_greedy_scores_and_evaluate_actions():
    jm, params, pm = _pair("PPOReranker", max_list_len=N)
    feats, mask, _ = _lists(3)
    tf, tm = torch.from_numpy(feats), torch.from_numpy(mask)
    want = jm.apply({"params": params}, feats, mask)
    got = pm(tf, tm)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    perm = _perm(4)
    jl, je, jv = jm.apply({"params": params}, feats, mask, perm,
                          method=jm.evaluate_actions)
    pl, pe, pv = pm.evaluate_actions(tf, tm, torch.from_numpy(perm))
    for g, w, name in ((pl, jl, "logp"), (pe, je, "entropy"),
                       (pv, jv, "value")):
        _close(g, w, msg=name)


LOSSES = ["reinforce", "reinforce_masked", "ppo", "ppo_masked", "ndcg"]


@pytest.mark.parametrize("loss", LOSSES)
def test_losses_and_gradients_match_jax(loss):
    rng = np.random.default_rng(5)
    logp = np.log(rng.uniform(0.05, 1.0, (B, N))).astype(np.float32)
    logp_old = (logp + 0.1 * rng.normal(size=(B, N))).astype(np.float32)
    value = rng.normal(size=B).astype(np.float32)
    reward = rng.uniform(size=B).astype(np.float32)
    ent = rng.uniform(size=(B, N)).astype(np.float32)
    _, mask, labels = _lists(6)
    step_mask = np.arange(N)[None, :] < mask.sum(1)[:, None]
    sm = step_mask if loss.endswith("masked") else None
    perm = _perm(7)

    def f(mod, lib, lp, v, r):
        t = (lambda a: a) if lib is jnp else \
            (lambda a: None if a is None else torch.from_numpy(a))
        if loss.startswith("reinforce"):
            return mod.reinforce_loss(lp, r, baseline=lib.mean(r),
                                      step_mask=t(sm))
        if loss.startswith("ppo"):
            return mod.ppo_loss(lp, t(logp_old), r - v, v, r, ent_coef=0.1,
                                entropy=t(ent), step_mask=t(sm))
        return lib.sum(mod.list_reward_ndcg(t(perm), r[:, None] * t(labels)
                                            + 0.0 * lp, t(mask), k=3))

    jl, jg = jax.value_and_grad(
        lambda *a: f(J, jnp, *a), argnums=(0, 1, 2))(
            jnp.asarray(logp), jnp.asarray(value), jnp.asarray(reward))
    ins = [torch.tensor(a, requires_grad=True)
           for a in (logp, value, reward)]
    pl = f(P, torch, *ins)
    pg = torch.autograd.grad(pl, ins, allow_unused=True)
    _close(pl, jl)
    for g, x, w, name in zip(pg, ins, jg, ("logp", "value", "reward")):
        _close(torch.zeros_like(x) if g is None else g, w, msg=name)


def test_rollout_is_a_valid_permutation_with_its_log_probs():
    _, _, pm = _pair("PPOReranker", max_list_len=N)
    feats, mask, _ = _lists(8)
    tf, tm = torch.from_numpy(feats), torch.from_numpy(mask)
    gen = torch.Generator().manual_seed(0)
    perm, logp, value = pm.rollout(tf, tm, gen)
    assert perm.shape == (B, N) and logp.shape == (B, N)
    for row, m in zip(perm.numpy(), mask):
        assert sorted(row) == list(range(N))
        assert set(row[:m.sum()]) == set(np.flatnonzero(m))
    el, _, ev = pm.evaluate_actions(tf, tm, perm)
    _close(logp, el.detach().numpy())
    _close(value, ev.detach().numpy())


def test_rollout_first_pick_follows_the_softmax():
    """The first pick's frequencies over 4000 draws of a full list against
    the softmax of the first step's logits (chi-square, p > 1e-3)."""
    _, _, pm = _pair("PPOReranker", max_list_len=N)
    feats, mask, _ = _lists(9)
    tf = torch.from_numpy(feats[:1]).expand(4000, N, D)
    tm = torch.from_numpy(mask[:1]).expand(4000, N)
    with torch.no_grad():
        perm, _, _ = pm.rollout(tf, tm, torch.Generator().manual_seed(1))
        # log-probs of every slot as the first pick
        probs = np.exp([pm.evaluate_actions(
            tf[:1], tm[:1], torch.tensor([[s] + [x for x in range(N)
                                                 if x != s]]))[0][0, 0]
            .item() for s in range(N)])
    counts = np.bincount(perm[:, 0].numpy(), minlength=N)
    assert abs(probs.sum() - 1) < 1e-5
    assert stats.chisquare(counts, probs / probs.sum() * 4000).pvalue > 1e-3


def test_ppo_update_adam_step_matches_jax():
    jm, params, pm = _pair("PPOReranker", max_list_len=N)
    feats, mask, labels = _lists(10)
    perm = _perm(11)
    jl, _, jv = jm.apply({"params": params}, feats, mask, perm,
                         method=jm.evaluate_actions)
    r = J.list_reward_ndcg(jnp.asarray(perm), jnp.asarray(labels),
                           jnp.asarray(mask), k=3)
    step_mask = np.arange(N)[None, :] < mask.sum(1)[:, None]

    def jloss(p):
        lp, ent, v = jm.apply({"params": p}, feats, mask, perm,
                              method=jm.evaluate_actions)
        return J.ppo_loss(lp, jl, r - jv, v, r, ent_coef=0.01,
                          entropy=ent, step_mask=step_mask)

    tx = optax.adam(5e-3)
    g = jax.grad(jloss)(params)
    up, _ = tx.update(g, tx.init(params))
    want = from_jax_params(_np_tree(optax.apply_updates(params, up)), pm)

    tl, tm = torch.from_numpy(np.array(jl)), torch.from_numpy(mask)
    tr, tv = torch.from_numpy(np.asarray(r)), torch.from_numpy(
        np.asarray(jv))
    named = dict(pm.named_parameters())
    opt = _make_optimizer(TrainerConfig(learning_rate=5e-3,
                                        grad_clip_norm=0.0),
                          list(named.values()))
    lp, ent, v = pm.evaluate_actions(torch.from_numpy(feats), tm,
                                     torch.from_numpy(perm))
    loss = P.ppo_loss(lp, tl, tr - tv, v, tr, ent_coef=0.01, entropy=ent,
                      step_mask=torch.from_numpy(step_mask))
    _close(loss, jloss(params))
    opt.step(torch.autograd.grad(loss, list(named.values())))
    for k, p in named.items():
        _close(p, want[k].numpy(), msg=k)


def _rl_lists(seed, n_lists):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n_lists, N, D)).astype(np.float32)
    labels = (feats[..., 0] > 0.3).astype(np.float32)
    mask = np.ones((n_lists, N), bool)
    mask[::3, -2:] = False
    return {"item_feats": feats, "labels": labels * mask, "mask": mask}


@pytest.mark.parametrize("model", ["EGR", "EGREvaluator", "PPOReranker"])
def test_run_rerank_experiment_paired_with_jax(monkeypatch, model):
    """EGR / EGREvaluator train under the listwise BCE; PPOReranker's
    greedy scores carry no gradient, so its parameters stay at the initial
    draw in both packages."""
    cfg = {"model": model, "epochs": 2, "batch_size": 16,
           "learning_rate": 1e-2, "monitor": "NDCG@5", "d_model": DM,
           "max_list_len": N}
    train, valid = _rl_lists(3, 48), _rl_lists(4, 16)
    with record_jax_inits(monkeypatch) as inits:
        want = jrun(cfg, train, valid, ks=(3, 5))
    assert len(inits) == 1
    load_inits(monkeypatch, inits)
    got = qs.run_rerank_experiment(cfg, train, valid, ks=(3, 5),
                                   device="cpu")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_egr_discriminator_fails_listwise_bce_in_both():
    cfg = {"model": "EGRDiscriminator", "epochs": 1, "batch_size": 8,
           "d_model": DM, "hidden_units": [8]}
    train, valid = _rl_lists(5, 16), _rl_lists(6, 8)
    with pytest.raises(Exception):
        jrun(cfg, train, valid)
    with pytest.raises(RuntimeError):
        qs.run_rerank_experiment(cfg, train, valid, device="cpu")


def test_cascade_stage_three_takes_egr_paired_with_jax(tmp_path,
                                                       monkeypatch):
    """`run_cascade_experiment(reranker='EGR')` equals JAX's run from the
    same three initial draws (`test_torch_cascade.py`'s short-pool data
    and knobs, atol 1e-5)."""
    from test_torch_cascade import _gen_short_pools

    from recbox_tpu.quick_start import run_cascade_experiment as jcascade
    root = str(tmp_path)
    _gen_short_pools(root, "casc_rl")
    kw = dict(data_dir=root, order="RO", matcher_epochs=1, ranker_epochs=1,
              reranker_epochs=2, candidates=30, list_len=8,
              embedding_dim=8, batch_size=64, topk_eval=(3, 5),
              num_cross_layers=1, hidden_units=[8], d_model=8,
              reranker="EGR")
    with record_jax_inits(monkeypatch) as inits:
        want = jcascade("casc_rl", **kw)
    assert len(inits) == 3
    queue = load_inits(monkeypatch, inits)
    got = qs.run_cascade_experiment("casc_rl", device="cpu", **kw)
    assert not queue and list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
