"""The port's listwise rerankers and their losses against the JAX package's,
on the CPU.

PRM, DLCM, SetRank, MiDNN and GSF get the flax model's params (`interop`)
and the same numpy lists: ragged (valid slots a prefix of each list, one
list of a single slot) and masked; MiDNN also over a list with no valid
slot (no NaN). Compared: the scores at the valid slots, the gradients of
`listwise_bce` with respect to every parameter, and both losses' values
and gradients with respect to the scores. GSF runs at a list length that
is not a multiple of its group size. `run_rerank_experiment` on a toy list
set (listwise BCE, Adam, 3 epochs) runs paired: the port's model starts
from the JAX run's initial params (recorded from JAX's `Trainer.init`),
and both give the same MAP / NDCG / clicks@k.

Tolerances: f32 scores rtol 1e-5 (atol 1e-6), gradients rtol 1e-4 (atol
1e-6), the losses rtol 1e-6; the paired experiment's metrics atol 1e-6
(they are sums of ranks of scores that agree to ~1e-6).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import flax.linen as fnn
import recbox_tpu.training.trainer as jtrainer_mod
from recbox_tpu.models.reranking import models as J
from recbox_tpu.quick_start import run_rerank_experiment as jrun
from recbox_tpu_torch import quick_start as qs
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.reranking import models as P

B, N, D = 5, 7, 6


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _lists(seed, b=B, n=N, d=D, empty=False):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, d)).astype(np.float32)
    lens = rng.integers(1, n + 1, b)
    lens[0], lens[1] = n, 1
    if empty:
        lens[-1] = 0
    mask = np.arange(n)[None, :] < lens[:, None]
    labels = (rng.random((b, n)) < 0.4).astype(np.float32) * mask
    return feats, mask, labels


RERANKERS = [
    ("PRM", dict(d_model=8, n_layers=2, n_heads=2, max_list_len=N)),
    ("DLCM", dict(hidden_size=5)),
    ("SetRank", dict(d_model=8, n_layers=1, n_heads=2)),
    ("MiDNN", dict(hidden_units=(8, 4))),
    ("GSF", dict(group_size=3, hidden_units=(8,))),
    ("GSF", dict(group_size=N + 2, hidden_units=(8,))),
]


@pytest.mark.parametrize("name,kw", RERANKERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(RERANKERS)])
def test_reranker_scores_and_grads_match_jax(name, kw):
    feats, mask, labels = _lists(0, empty=name == "MiDNN")
    jm = getattr(J, name)(**kw)
    pm = getattr(P, name)(D, device="cpu", **kw)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), feats, mask))["params"]
    pm.load_state_dict(from_jax_params(params, pm))

    def jloss(p):
        s = jm.apply({"params": p}, feats, mask)
        return J.listwise_bce(s, labels, mask), s

    (jl, js), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tm, tl = torch.from_numpy(mask), torch.from_numpy(labels)
    s = pm(torch.from_numpy(feats), tm)
    assert s.shape == (B, N) and torch.isfinite(s).all()
    np.testing.assert_allclose(s.detach().numpy()[mask], np.asarray(js)[mask],
                               rtol=1e-5, atol=1e-6)
    loss = P.listwise_bce(s, tl, tm)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    expect = from_jax_params(_np_tree(jg), pm)
    named = dict(pm.named_parameters())
    assert set(expect) == set(named)
    for k, g in expect.items():
        assert torch.isfinite(named[k].grad).all(), k
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("loss", ["listwise_bce", "listwise_softmax_ce"])
def test_listwise_losses_match_jax(loss):
    _, mask, labels = _lists(1, empty=True)
    scores = np.random.default_rng(2).normal(size=mask.shape).astype(
        np.float32)
    scores[~mask] = np.nan if loss == "listwise_bce" else 1e4
    jl, jg = jax.value_and_grad(
        lambda s: getattr(J, loss)(s, labels, mask))(scores)
    ts = torch.tensor(scores, requires_grad=True)
    pl_ = getattr(P, loss)(ts, torch.from_numpy(labels),
                           torch.from_numpy(mask))
    pl_.backward()
    assert np.isfinite(float(pl_.detach()))
    np.testing.assert_allclose(float(pl_.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


def test_gsf_group_scatter_at_a_ragged_length():
    """Member j of group g is item (g + j) mod N: each item's score is the
    mean over the m groups holding it, here at N = 7, m = 3."""
    pm = P.GSF(2, group_size=3, hidden_units=(4,), device="cpu")
    feats = torch.randn(2, N, 2)
    mask = torch.ones(2, N, dtype=torch.bool)
    per_group = pm.group_mlp(feats[:, (torch.arange(N)[:, None]
                                       + torch.arange(3)) % N].reshape(
        2, N, 6))
    want = torch.zeros(2, N)
    for g in range(N):
        for j in range(3):
            want[:, (g + j) % N] += per_group[:, g, j]
    torch.testing.assert_close(pm(feats, mask), want / 3)


@contextlib.contextmanager
def record_jax_inits(monkeypatch):
    """The initial params of every JAX `Trainer.init` in the block, in
    order."""
    inits = []
    orig = jtrainer_mod.Trainer.init

    def init(self, sample_batch):
        orig(self, sample_batch)
        inits.append(_np_tree(self.params))

    monkeypatch.setattr(jtrainer_mod.Trainer, "init", init)
    yield inits
    monkeypatch.setattr(jtrainer_mod.Trainer, "init", orig)


def load_inits(monkeypatch, inits):
    """Make the port's `build_model` and `build_reranker` load the next of
    ``inits`` into each model they build."""
    queue = list(inits)
    for name in ("build_model", "build_reranker"):
        orig = getattr(qs, name)

        def build(*args, _orig=orig, **kw):
            out = _orig(*args, **kw)
            model = out[0] if isinstance(out, tuple) else out
            model.load_state_dict(from_jax_params(queue.pop(0), model))
            return out

        monkeypatch.setattr(qs, name, build)
    return queue


def _toy_lists(seed, n_lists):
    """Lists whose relevant slots carry a planted feature direction."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n_lists, N, D)).astype(np.float32)
    labels = (feats[..., 0] + 0.5 * rng.normal(size=(n_lists, N))
              > 0.8).astype(np.float32)
    mask = np.ones((n_lists, N), bool)
    mask[::3, -2:] = False
    return {"item_feats": feats, "labels": labels * mask, "mask": mask}


@pytest.mark.parametrize("model", ["PRM", "MiDNN"])
def test_run_rerank_experiment_paired_with_jax(monkeypatch, model):
    cfg = {"model": model, "epochs": 3, "batch_size": 16,
           "learning_rate": 1e-2, "monitor": "NDCG@5", "d_model": 8,
           "n_heads": 2, "n_layers": 1, "max_list_len": N,
           "hidden_units": [8]}
    train, valid = _toy_lists(3, 64), _toy_lists(4, 24)
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
    assert got["NDCG@5"] > 0.5


def test_run_rerank_experiment_refuses_a_non_reranker():
    with pytest.raises(ValueError, match="not a reranker"):
        qs.run_rerank_experiment({"model": "DeepFM"}, _toy_lists(0, 4),
                                 _toy_lists(1, 4), device="cpu")
