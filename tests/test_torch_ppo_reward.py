"""PPO's loop over updates: the port's against the JAX package's.

Phase 5p's PPO loop (`chip_smoke.py`) on the CPU in both packages, from
the same initial parameters (JAX's init, moved by `interop`), over the
same lists: PPOReranker at `configs/models/pporeranker.yaml`'s widths,
updates of a rollout of lists (30 slots x 65 features, 5p's generator
rebuilt in numpy: a planted linear score, a noisy ranker-score column,
clicks in each list's top third, every fourth list post-padded) from a
frozen copy of the policy, `list_reward_ndcg`, then 4 Adam steps (lr
5e-3, no clip) of `ppo_loss` (entropy 0.01) over `evaluate_actions`.

The collected test hands the port JAX's sampled permutations, so both
loops take the same actions, and holds each update's rewards and old
log-probs (the policy after the updates before it) to JAX's. Run as a
script, each package samples from its own stream (JAX's key, the port's
torch generator), so the loops part from the first draw; over the seeds
the mean rewards of the first two and the last two rollouts say whether
the port's loop learns as JAX's does (one JSON object):

    python tests/test_torch_ppo_reward.py [--seeds 0 1 2] [--lists 2048]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from recbox_tpu.models.reranking import rl as J  # noqa: E402
from recbox_tpu_torch.interop import from_jax_params  # noqa: E402
from recbox_tpu_torch.models.reranking import rl as P  # noqa: E402
from recbox_tpu_torch.training.trainer import (  # noqa: E402
    TrainerConfig, _make_optimizer,
)

N, FEATS, D_MODEL = 30, 65, 64
UPDATES, INNER, LR = 8, 4, 5e-3


def lists(n, seed):
    """5p's `rl_lists` in numpy."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=FEATS - 1).astype(np.float32)
    feats = rng.normal(size=(n, N, FEATS)).astype(np.float32)
    score = feats[..., :-1] @ w
    feats[..., -1] = (score + score.std() * rng.normal(size=(n, N))) \
        / score.std()
    mask = np.ones((n, N), bool)
    mask[::4, -5:] = False
    masked = np.where(mask, score, -1e9)
    rank = np.argsort(np.argsort(-masked, axis=1, kind="stable"), axis=1)
    labels = ((rank < N // 3) & mask).astype(np.float32)
    return feats, mask, labels


def jax_loop(model, params, feats, mask, labels, seed, updates=UPDATES):
    """(each update's mean reward, its permutations, their old
    log-probs)."""
    step_mask = np.arange(N)[None, :] < mask.sum(1)[:, None]
    tx = optax.adam(LR)
    opt = tx.init(params)
    key = jax.random.PRNGKey(seed)
    rollout = jax.jit(lambda p, k: model.apply(
        {"params": p}, feats, mask, k, method=model.rollout))

    def loss_fn(p, perm, logp_old, r, v_old):
        lp, ent, v = model.apply({"params": p}, feats, mask, perm,
                                 method=model.evaluate_actions)
        return J.ppo_loss(lp, logp_old, r - v_old, v, r, ent_coef=0.01,
                          entropy=ent, step_mask=step_mask)

    grad = jax.jit(jax.grad(loss_fn))
    rewards, perms, logps = [], [], []
    for _ in range(updates):
        key, sub = jax.random.split(key)
        perm, logp_old, v_old = rollout(params, sub)
        r = J.list_reward_ndcg(perm, jnp.asarray(labels), jnp.asarray(mask))
        rewards.append(float(jnp.mean(r)))
        perms.append(np.asarray(perm))
        logps.append(np.asarray(logp_old))
        for _ in range(INNER):
            g = grad(params, perm, logp_old, r, v_old)
            up, opt = tx.update(g, opt, params)
            params = optax.apply_updates(params, up)
    return rewards, perms, logps


def port_loop(model, feats, mask, labels, seed, perms=None):
    """(each update's mean reward, its old log-probs): the rollouts drawn
    from the port's generator, or the permutations ``perms`` evaluated."""
    tf, tm = torch.from_numpy(feats), torch.from_numpy(mask)
    tl = torch.from_numpy(labels)
    step_mask = torch.arange(N)[None, :] < tm.sum(1)[:, None]
    params = list(model.parameters())
    opt = _make_optimizer(TrainerConfig(learning_rate=LR, grad_clip_norm=0.0),
                          params)
    draws = torch.Generator().manual_seed(seed)
    rewards, logps = [], []
    for u in range(UPDATES if perms is None else len(perms)):
        old = copy.deepcopy(model)
        with torch.no_grad():
            if perms is None:
                perm, logp_old, v_old = old.rollout(tf, tm, draws)
            else:
                perm = torch.from_numpy(np.array(perms[u])).long()
                logp_old, _, v_old = old.evaluate_actions(tf, tm, perm)
            r = P.list_reward_ndcg(perm, tl, tm)
        rewards.append(float(r.mean()))
        logps.append(logp_old.numpy())
        for _ in range(INNER):
            lp, ent, v = model.evaluate_actions(tf, tm, perm)
            loss = P.ppo_loss(lp, logp_old, r - v_old, v, r, ent_coef=0.01,
                              entropy=ent, step_mask=step_mask)
            opt.step(torch.autograd.grad(loss, params))
    return rewards, logps


def _pair(seed, n_lists):
    """JAX's and the port's PPOReranker from JAX's init, and the lists."""
    feats, mask, labels = lists(n_lists, 1000 + seed)
    jm = J.PPOReranker(d_model=D_MODEL, max_list_len=N)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jm.init(jax.random.PRNGKey(seed), jnp.asarray(feats[:2]),
                jnp.asarray(mask[:2]))["params"])
    pm = P.PPOReranker(FEATS, d_model=D_MODEL, max_list_len=N, device="cpu")
    pm.load_state_dict(from_jax_params(params, pm))
    return jm, params, pm, (feats, mask, labels)


def test_ppo_loop_follows_jax_on_its_actions():
    """Three updates over 64 lists, the port taking JAX's sampled actions:
    each rollout's mean reward within 1e-6, and its old log-probs (the
    policy after the updates before it: every Adam step of `ppo_loss`
    counts) within 1e-4 of JAX's on every valid step (5e-6 apart after
    three updates)."""
    jm, params, pm, (feats, mask, labels) = _pair(0, 64)
    jr, perms, jlogps = jax_loop(jm, params, feats, mask, labels, 0,
                                 updates=3)
    pr, plogps = port_loop(pm, feats, mask, labels, 0, perms=perms)
    np.testing.assert_allclose(pr, jr, rtol=0, atol=1e-6)
    valid = np.arange(N)[None, :] < mask.sum(1)[:, None]
    for u, (a, b) in enumerate(zip(plogps, jlogps)):
        np.testing.assert_allclose(a[valid], b[valid], rtol=0, atol=1e-4,
                                   err_msg=f"update {u}")
    # the updates moved the policy
    assert np.abs(jlogps[-1] - jlogps[0])[valid].max() > 1e-2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--lists", type=int, default=2048)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    out = {"updates": UPDATES, "inner_steps": INNER, "lists": args.lists,
           "seeds": {}}
    for seed in args.seeds:
        jm, params, pm, (feats, mask, labels) = _pair(seed, args.lists)
        jr, _, _ = jax_loop(jm, params, feats, mask, labels, seed)
        pr, _ = port_loop(pm, feats, mask, labels, seed)
        out["seeds"][seed] = {"jax": jr, "port": pr}
    gain = {k: [np.mean(v[k][-2:]) - np.mean(v[k][:2])
                for v in out["seeds"].values()] for k in ("jax", "port")}
    out["gain_last2_minus_first2"] = gain
    out["gain_mean"] = {k: float(np.mean(v)) for k, v in gain.items()}
    out["gain_spread"] = {k: float(np.std(v)) for k, v in gain.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
