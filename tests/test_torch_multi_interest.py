"""MIND, ComiRec, SimpleX and YoutubeSBC of the port against the JAX package,
on the CPU.

- The capsule routing's fixed draw (`nn.fixed_draws.jax_normal`) against
  ``jax.random.normal(PRNGKey(17), (1, K, L))`` for K ∈ {2, 3, 4, 8},
  L ∈ {1, 10, 50, 200}: the threefry bits and the uniform bit for bit,
  the normal within 16 ulp (XLA's log1p differs from numpy's in the last
  bits).
- `CapsuleNetwork` and `MultiInterestSA` on JAX's initial params, an
  all-PAD history among the rows: forward and gradients, rtol 1e-5 /
  1e-4.
- The models on JAX's initial params (moved by `interop.from_jax_params`,
  every parameter filled): the training scores of a `MatchingLoader`
  batch, ``user_tower`` ((B, K, D) for the multi-interest models), the
  BPR loss's gradients and one Adam step of `Trainer.train_step`.
- YoutubeSBC's in-batch scores and `sampled_softmax_inbatch_loss` with a
  log-q correction.
- `RetrievalService.from_trainer` on a multi-interest model: the (B, K, D)
  route's top-k against JAX's, ties aside (`_sets_equal_but_ties`).
- `run_matching_experiment` with MIND, paired with JAX's by its initial
  weights: the history columns reach the model through `MatchingLoader`,
  the evaluator takes the max over the interests, the metrics agree within
  1e-4.
"""

import flax.linen as fnn
import recbox_tpu.training.trainer as jtrainer_mod
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.data import MatchingLoader as JMatchingLoader
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.matching import multi_interest as J
from recbox_tpu.nn import attention as jattention
from recbox_tpu.ops import get_matching_loss as jget_matching_loss
from recbox_tpu.quick_start import run_matching_experiment as jrun_matching
from recbox_tpu.retrieval import RetrievalService as JRetrievalService
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch import quick_start as qs
from recbox_tpu_torch.data import MatchingLoader
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.matching import multi_interest as P
from recbox_tpu_torch.nn import attention as pattention
from recbox_tpu_torch.nn.fixed_draws import (
    jax_normal, jax_uniform, threefry_bits,
)
from recbox_tpu_torch.ops.losses import get_matching_loss
from recbox_tpu_torch.retrieval import RetrievalService
from recbox_tpu_torch.training import Trainer, TrainerConfig
from tests.test_torch_retrieval import _sets_equal_but_ties
from tests.test_torch_reranking import load_inits

RTOL, GTOL, ATOL = 1e-5, 1e-4, 1e-7
N_USERS, N_ITEMS, DIM, L, K, B = 40, 60, 8, 6, 3, 16


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("length", [1, 10, 50, 200])
def test_capsule_draw_matches_jax(k, length):
    key = jax.random.PRNGKey(17)
    shape = (1, k, length)
    np.testing.assert_array_equal(
        threefry_bits(17, shape),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    np.testing.assert_array_equal(
        jax_uniform(17, shape),
        np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0)))
    want = np.asarray(jax.random.normal(key, shape))
    got = jax_normal(17, shape)
    assert got.dtype == np.float32
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 16, ulp.max()


def _maps():
    specs = [("user_id", "user", N_USERS), ("item_id", "item", N_ITEMS)]
    kw = dict(query_index="user_id", corpus_index="item_id",
              num_items=N_ITEMS)
    return (JFeatureMap("mi", tuple(JFeatureSpec(n, "categorical", s,
                                                 vocab_size=v,
                                                 embedding_dim=DIM)
                                    for n, s, v in specs), **kw),
            FeatureMap("mi", tuple(FeatureSpec(n, "categorical", s,
                                               vocab_size=v,
                                               embedding_dim=DIM)
                                   for n, s, v in specs), **kw))


def _data(seed=0, n=200):
    """Interactions with each row's history (left-aligned, 0-padded; row 0
    of every eighth user's history all PAD)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, n).astype(np.int32)
    lens = rng.integers(0, L + 1, n)
    lens[::8] = 0
    seq = rng.integers(1, N_ITEMS, (n, L)).astype(np.int32)
    seq[np.arange(L)[None, :] >= lens[:, None]] = 0
    return {"user_id": users, "item_id": rng.integers(
                1, N_ITEMS, n).astype(np.int32),
            "item_seq": seq, "seq_len": lens.astype(np.int32)}


def _batch(data, seed=5):
    jfm, pfm = _maps()
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    jb = next(iter(JMatchingLoader(jfm, data, corpus, batch_size=B,
                                   num_negs=3, seed=seed)))
    pb = next(iter(MatchingLoader(pfm, data, corpus, batch_size=B,
                                  num_negs=3, seed=seed)))
    assert set(jb) == set(pb)
    for key in jb:
        np.testing.assert_array_equal(jb[key], pb[key])
    assert "item_seq" in pb and "seq_len" in pb
    return jb, pb


MODELS = {
    "MIND": dict(interest_num=K, routing_rounds=3),
    "ComiRec": dict(interest_num=K),
    "SimpleX": dict(gamma=0.3),
    "YoutubeSBC": dict(user_hidden_units=(16, DIM),
                       item_hidden_units=(16, DIM)),
}


def _models(name, seed=0):
    """(JAX model, its numpy params, port model holding them, batches)."""
    jfm, pfm = _maps()
    jb, pb = _batch(_data(seed))
    kw = dict(MODELS[name], embedding_dim=DIM)
    jm = getattr(J, name)(feature_map=jfm, **kw)
    jparams = _np(jm.init(jax.random.PRNGKey(seed), jb)["params"])
    pm = getattr(P, name)(pfm, device="cpu",
                          generator=torch.Generator().manual_seed(seed + 9),
                          **kw)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    state = from_jax_params(jparams, pm)
    assert set(state) == set(before)
    pm.load_state_dict(state)
    for key, v in pm.state_dict().items():
        # every drawn entry comes from JAX (a constant init, a zero bias or
        # a LayerNorm scale, is the same in both)
        assert not torch.equal(v, before[key]) \
            or bool((v == v.flatten()[0]).all()), key
    return jm, jparams, pm, jb, pb


def _check_grads(pm, jgrads, ploss):
    """Each gradient within rtol 1e-4, or 1e-4 of the model's largest
    gradient entry: a gradient the loss does not depend on (YoutubeSBC's
    item-side output bias shifts a row's scores alike) is rounding noise
    in both packages."""
    want = from_jax_params(_np(jgrads), pm)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(ploss, [p for _, p in pm.named_parameters()])
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=GTOL,
                                   atol=GTOL * top, err_msg=n)


@pytest.mark.parametrize("kind", ["capsule", "sa"])
def test_extractor_matches_jax(kind):
    rng = np.random.default_rng(3)
    hist = rng.normal(size=(5, L, DIM)).astype(np.float32)
    mask = rng.random((5, L)) < 0.7
    mask[2] = False                                    # an all-PAD history
    hist = hist * mask[..., None]
    if kind == "capsule":
        jmod = jattention.CapsuleNetwork(interest_num=K, routing_rounds=3)
        pmod = pattention.CapsuleNetwork(DIM, K, 3, device="cpu")
    else:
        jmod = jattention.MultiInterestSA(interest_num=K)
        pmod = pattention.MultiInterestSA(DIM, K, device="cpu")
    jparams = _np(jmod.init(jax.random.PRNGKey(1), hist, mask)["params"])
    pmod.load_state_dict(from_jax_params(jparams, pmod))
    want = np.asarray(jmod.apply({"params": jparams}, hist, mask))
    th = torch.from_numpy(hist).requires_grad_(True)
    got = pmod(th, torch.from_numpy(mask))
    assert got.shape == (5, K, DIM)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    # the gradients of a weighted sum, to the parameters and the history
    wts = np.random.default_rng(4).normal(size=want.shape).astype(np.float32)

    def jloss(p, h):
        return jnp.sum(jmod.apply({"params": p}, h, mask) * wts)
    jg_p, jg_h = jax.grad(jloss, argnums=(0, 1))(jparams, hist)
    ploss = torch.sum(got * torch.from_numpy(wts))
    g_h = torch.autograd.grad(ploss, th, retain_graph=True)[0]
    np.testing.assert_allclose(g_h.numpy(), np.asarray(jg_h), rtol=GTOL,
                               atol=GTOL * np.abs(jg_h).max())
    _check_grads(pmod, jg_p, ploss)


@pytest.mark.parametrize("name", ["MIND", "ComiRec", "SimpleX"])
def test_model_matches_jax(name):
    jm, jparams, pm, jb, pb = _models(name)
    loss = jget_matching_loss("PairwiseLogisticLoss")
    want = np.asarray(jm.apply({"params": jparams}, jb))
    got = pm(_t(pb))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    users = {k: jb[k] for k in ("user_id", "item_seq", "seq_len")}
    want_u = np.asarray(jm.apply({"params": jparams}, users,
                                 method=jm.user_tower))
    got_u = pm.user_tower(_t(users)).detach().numpy()
    assert got_u.shape == want_u.shape
    if name != "SimpleX":
        assert got_u.shape == (B, K, DIM)
    np.testing.assert_allclose(got_u, want_u, rtol=RTOL, atol=ATOL)
    jgrads = jax.grad(lambda p: loss(jm.apply({"params": p}, jb)))(jparams)
    _check_grads(pm, jgrads,
                 get_matching_loss("PairwiseLogisticLoss")(pm(_t(pb))))


@pytest.mark.parametrize("name", ["MIND", "ComiRec", "SimpleX"])
def test_one_adam_step_matches_jax(name):
    jm, jparams, pm, jb, pb = _models(name)
    cfg = dict(learning_rate=1e-2, embedding_regularizer=1e-3)
    jt = JTrainer(jm, lambda o, b: jget_matching_loss(
        "PairwiseLogisticLoss")(o), JTrainerConfig(**cfg))
    jt.init(jb)
    jt.params = jax.tree_util.tree_map(jnp.asarray, jparams)
    jt.opt_state = jt.tx.init(jt.params)
    pt = Trainer(pm, lambda o, b: get_matching_loss(
        "PairwiseLogisticLoss")(o), TrainerConfig(**cfg), device="cpu")
    np.testing.assert_allclose(float(pt.train_step(dict(pb))),
                               float(jt.train_step(dict(jb))), rtol=RTOL)
    want = from_jax_params(_np(jt.params), pm)
    for key, v in pm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[key].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_youtube_sbc_inbatch_loss_matches_jax():
    jm, jparams, pm, jb, pb = _models("YoutubeSBC")
    log_q = np.log(np.random.default_rng(2).uniform(
        1e-3, 1e-1, B)).astype(np.float32)
    want = np.asarray(jm.apply({"params": jparams}, jb,
                               method=jm.inbatch_scores))
    got = pm.inbatch_scores(_t(pb))
    assert got.shape == (B, B)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)

    def jloss(p):
        return J.sampled_softmax_inbatch_loss(
            jm.apply({"params": p}, jb, method=jm.inbatch_scores),
            jnp.asarray(log_q))
    ploss = P.sampled_softmax_inbatch_loss(pm.inbatch_scores(_t(pb)),
                                           torch.from_numpy(log_q))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss(jparams)),
                               rtol=RTOL)
    np.testing.assert_allclose(
        float(P.sampled_softmax_inbatch_loss(got)),
        float(J.sampled_softmax_inbatch_loss(jnp.asarray(want))), rtol=RTOL)
    _check_grads(pm, jax.grad(jloss)(jparams), ploss)


@pytest.mark.parametrize("name", ["MIND", "ComiRec"])
def test_service_multi_interest_route_matches_jax(name):
    jm, jparams, pm, jb, pb = _models(name)
    # larger tables, so the scores rank apart
    rng = np.random.default_rng(8)
    jparams["emb_item"] = rng.normal(size=(N_ITEMS, DIM)).astype(np.float32)
    pm.load_state_dict(from_jax_params(jparams, pm))
    loss = jget_matching_loss("PairwiseLogisticLoss")
    jt = JTrainer(jm, lambda o, b: loss(o), JTrainerConfig())
    jt.init(jb)
    jt.params = jax.tree_util.tree_map(jnp.asarray, jparams)
    pt = Trainer(pm, lambda o, b: get_matching_loss(
        "PairwiseLogisticLoss")(o), TrainerConfig(), device="cpu")
    pt.init(pb)
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    data = _data(1, n=24)
    users = {k: data[k] for k in ("user_id", "item_seq", "seq_len")}
    jsvc = JRetrievalService.from_trainer(jt, corpus)
    psvc = RetrievalService.from_trainer(pt, corpus)
    for k in (5, 20):
        js, ji = jsvc.query(users, k=k)
        ps, pi = psvc.query(users, k=k)
        assert pi.shape == ji.shape == (24, k)
        assert _sets_equal_but_ties(ps, pi, js, ji)
        np.testing.assert_allclose(ps, np.asarray(js), rtol=RTOL,
                                   atol=1e-6)
        # each row's merged list holds no id twice
        for r in range(24):
            assert len(set(pi[r].tolist())) == k


def test_run_matching_experiment_mind_paired_with_jax(monkeypatch):
    jfm, pfm = _maps()
    train = _data(6, n=320)
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    valid = _data(7, n=N_USERS)
    valid["user_id"] = np.arange(N_USERS, dtype=np.int32)
    vu = np.arange(N_USERS, dtype=np.int64)
    train_u2i, valid_u2i = {}, {}
    for u, i in zip(train["user_id"], train["item_id"]):
        train_u2i.setdefault(int(u), []).append(int(i))
    for u, i in zip(valid["user_id"], valid["item_id"]):
        valid_u2i.setdefault(int(u), []).append(int(i))
    users = {k: valid[k] for k in ("user_id", "item_seq", "seq_len")}
    cfg = {"model": "MIND", "embedding_dim": DIM, "interest_num": K,
           "epochs": 2, "batch_size": 64, "num_negs": 4,
           "learning_rate": 5e-2, "monitor": "Recall(k=20)",
           "metrics": ["Recall(k=20)", "NDCG(k=10)"], "eval_batch_size": 16,
           "exclude_items": [0]}
    # the item table at normal(0.1), not emb_init's 1e-4: from 1e-4 rows
    # the squashed capsules are ~1e-12 and Adam's first steps divide
    # gradients of the order of its eps, which turns rounding into
    # diverging runs in either package
    inits = []
    orig = jtrainer_mod.Trainer.init

    def init(self, sample):
        orig(self, sample)
        params = _np(self.params)
        params["emb_item"] = np.random.default_rng(0).normal(
            0, 0.1, params["emb_item"].shape).astype(np.float32)
        self.params = jax.tree_util.tree_map(jnp.asarray, params)
        self.opt_state = self.tx.init(self.params)
        inits.append(params)

    monkeypatch.setattr(jtrainer_mod.Trainer, "init", init)
    want = jrun_matching(cfg, jfm, train, corpus, users, vu, train_u2i,
                         valid_u2i)
    monkeypatch.setattr(jtrainer_mod.Trainer, "init", orig)
    assert len(inits) == 1
    load_inits(monkeypatch, inits)
    got = qs.run_matching_experiment(cfg, pfm, train, corpus, users, vu,
                                     train_u2i, valid_u2i, device="cpu")
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("interests", [0, K])
def test_evaluator_ranks_ties_by_ascending_id_as_jax(interests):
    """Users whose scores tie (an empty history's zero interests, equal
    item rows) rank the tied items by ascending id, as `lax.top_k` does:
    the metrics are JAX's."""
    from recbox_tpu.evaluation.retrieval import evaluate_retrieval as jev
    from recbox_tpu_torch.evaluation.retrieval import evaluate_retrieval
    rng = np.random.default_rng(12)
    shape = (30, interests, DIM) if interests else (30, DIM)
    users = rng.normal(size=shape).astype(np.float32)
    users[::3] = 0.0                                 # every item ties
    items = rng.normal(size=(N_ITEMS, DIM)).astype(np.float32)
    items[10:20] = items[5]                          # ten more equal rows
    train = {u: rng.choice(N_ITEMS, 4, replace=False).tolist()
             for u in range(30)}
    valid = {u: rng.choice(N_ITEMS, 3, replace=False).tolist()
             for u in range(30)}
    metrics = ("Recall(k=5)", "NDCG(k=10)", "MRR(k=20)")
    want = jev(users, items, train, valid, list(range(30)), metrics,
               exclude_items=(0,))
    got = evaluate_retrieval(users, items, train, valid, list(range(30)),
                             metrics, exclude_items=(0,), device="cpu")
    for m in metrics:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-6, err_msg=m)
