"""LightGCN and NGCF of the port against the JAX package, on the CPU.

- `build_norm_edges` equals JAX's array for array.
- LightGCN (2 hops) and NGCF (2 hops, message dropout 0) on the JAX
  model's initial params (moved over by `interop.from_jax_params`; every
  param is transplanted, none left at the port's draw): the training
  scores of a `MatchingLoader` batch, both towers, the gradients of the
  BPR loss and one Adam step of `Trainer.train_step` against JAX's, f32,
  rtol 1e-5 (atol 1e-7 for values near 0; a gradient within 1e-5 of its
  tensor's largest entry, since NGCF's normalization of 1e-4-scale rows
  gives gradients of ~100 whose small entries are differences of large
  terms): the hops sum their messages in ``index_add_``'s edge order, not
  in ``segment_sum``'s.
- `forward` propagates the graph once for both sides.
- `train_steps_fused` on the CPU equals K `train_step` calls bit for bit.
- ``emb_init_scheme`` takes the three JAX names and raises ValueError on
  any other.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.data import MatchingLoader as JMatchingLoader
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.matching import graph as jgraph
from recbox_tpu.ops import get_matching_loss as jget_matching_loss
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.data import MatchingLoader
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.matching import graph as pgraph
from recbox_tpu_torch.ops.losses import get_matching_loss
from recbox_tpu_torch.training import Trainer, TrainerConfig

RTOL, ATOL = 1e-5, 1e-7
N_USERS, N_ITEMS, DIM, N_INTER, B = 30, 40, 8, 300, 32


def _maps():
    specs = [("user_id", "user", N_USERS), ("item_id", "item", N_ITEMS)]
    kw = dict(query_index="user_id", corpus_index="item_id",
              num_items=N_ITEMS)
    return (JFeatureMap("g", tuple(JFeatureSpec(n, "categorical", s,
                                                vocab_size=v,
                                                embedding_dim=DIM)
                                   for n, s, v in specs), **kw),
            FeatureMap("g", tuple(FeatureSpec(n, "categorical", s,
                                              vocab_size=v,
                                              embedding_dim=DIM)
                                  for n, s, v in specs), **kw))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, N_USERS, N_INTER).astype(np.int32)
    items = rng.integers(0, N_ITEMS, N_INTER).astype(np.int32)
    return {"user_id": users, "item_id": items}


def _models(kind, seed=0):
    """(JAX model, its numpy params, port model with them, feature maps)."""
    jfm, pfm = _maps()
    data = _data(seed)
    eu, ei, c = jgraph.build_norm_edges(data["user_id"], data["item_id"],
                                        N_USERS, N_ITEMS)
    common = dict(embedding_dim=DIM, num_users=N_USERS, num_items=N_ITEMS,
                  n_layers=2)
    jcls = {"lightgcn": jgraph.LightGCN, "ngcf": jgraph.NGCF}[kind]
    pcls = {"lightgcn": pgraph.LightGCN, "ngcf": pgraph.NGCF}[kind]
    jm = jcls(feature_map=jfm, edge_users=tuple(eu.tolist()),
              edge_items=tuple(ei.tolist()), edge_coefs=tuple(c.tolist()),
              **common)
    batch = _batch(jfm, pfm, data)[0]
    jparams = jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(
        jm.init(jax.random.PRNGKey(seed), batch)["params"]))
    # a port draw of another seed: every entry must be overwritten
    pm = pcls(pfm, edge_users=eu, edge_items=ei, edge_coefs=c, device="cpu",
              generator=torch.Generator().manual_seed(seed + 99), **common)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    state = from_jax_params(jparams, pm)
    assert set(state) == set(before)
    pm.load_state_dict(state)
    for k, v in pm.state_dict().items():
        assert not torch.equal(v, before[k]) or not v.any(), k
    return jm, jparams, pm, data


def _batch(jfm, pfm, data, seed=5):
    jl = JMatchingLoader(jfm, data, {"item_id": np.arange(N_ITEMS,
                                                          dtype=np.int32)},
                         batch_size=B, num_negs=2, seed=seed)
    pl_ = MatchingLoader(pfm, data, {"item_id": np.arange(N_ITEMS,
                                                          dtype=np.int32)},
                         batch_size=B, num_negs=2, seed=seed)
    jb, pb = next(iter(jl)), next(iter(pl_))
    for k in jb:
        np.testing.assert_array_equal(jb[k], pb[k])
    return jb, pb


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_build_norm_edges_matches_jax():
    d = _data(3)
    d["user_id"][:5] = 2                  # repeated pairs count once
    d["item_id"][:5] = 7
    for a, b in zip(jgraph.build_norm_edges(d["user_id"], d["item_id"],
                                            N_USERS + 2, N_ITEMS),
                    pgraph.build_norm_edges(d["user_id"], d["item_id"],
                                            N_USERS + 2, N_ITEMS)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["lightgcn", "ngcf"])
def test_forward_towers_and_grads_match_jax(kind):
    jm, jparams, pm, data = _models(kind)
    jb, _ = _batch(*_maps(), data)
    loss = jget_matching_loss("PairwiseLogisticLoss")
    jscores = np.asarray(jm.apply({"params": jparams}, jb))
    pscores = pm(_t(jb))
    np.testing.assert_allclose(pscores.detach().numpy(), jscores,
                               rtol=RTOL, atol=ATOL)
    users = {"user_id": np.arange(N_USERS, dtype=np.int32)}
    items = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    for method, b in (("encode_user", users), ("encode_item", items)):
        want = np.asarray(jm.apply({"params": jparams}, b,
                                   method=getattr(jm, method)))
        got = getattr(pm, method)(_t(b)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=method)
    jgrads = jax.grad(lambda p: loss(jm.apply({"params": p}, jb)))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    jgrads = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads), pm)
    ploss = get_matching_loss("PairwiseLogisticLoss")(pm(_t(jb)))
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(ploss, [p for _, p in pm.named_parameters()])
    for n, g in zip(names, grads):
        want = jgrads[n].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=n)


@pytest.mark.parametrize("kind", ["lightgcn", "ngcf"])
def test_one_adam_step_matches_jax(kind):
    jm, jparams, pm, data = _models(kind)
    jb, pb = _batch(*_maps(), data)
    cfg = dict(learning_rate=1e-2, embedding_regularizer=1e-3)
    jt = JTrainer(jm, lambda o, b: jget_matching_loss(
        "PairwiseLogisticLoss")(o), JTrainerConfig(**cfg))
    jt.init(jb)
    jt.params = jax.tree_util.tree_map(jnp.asarray, jparams)
    jt.opt_state = jt.tx.init(jt.params)
    pt = Trainer(pm, lambda o, b: get_matching_loss("PairwiseLogisticLoss")(o),
                 TrainerConfig(**cfg), device="cpu")
    jloss = float(jt.train_step(dict(jb)))
    ploss = float(pt.train_step(dict(pb)))
    np.testing.assert_allclose(ploss, jloss, rtol=RTOL)
    want = from_jax_params(jax.tree_util.tree_map(
        np.asarray, fnn.meta.unbox(jt.params)), pm)
    for k, v in pm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_forward_propagates_once():
    _, _, pm, data = _models("lightgcn")
    _, pb = _batch(*_maps(), data)
    calls = []
    orig = pm.propagated
    pm.propagated = lambda *a: calls.append(1) or orig(*a)
    pm(_t(pb))
    assert len(calls) == 1
    pm.encode_user(_t({"user_id": pb["user_id"]}))
    assert len(calls) == 2


@pytest.mark.parametrize("kind", ["lightgcn", "ngcf"])
def test_train_steps_fused_equals_k_steps_on_cpu(kind):
    data = _data()
    _, pfm = _maps()
    eu, ei, c = pgraph.build_norm_edges(data["user_id"], data["item_id"],
                                        N_USERS, N_ITEMS)
    cls = {"lightgcn": pgraph.LightGCN, "ngcf": pgraph.NGCF}[kind]
    extra = {"dropout": 0.3} if kind == "ngcf" else {}
    loader = MatchingLoader(pfm, data, {"item_id": np.arange(
        N_ITEMS, dtype=np.int32)}, batch_size=B, num_negs=1, seed=1)
    batches = list(loader)[:4]
    trainers = []
    for _ in range(2):
        m = cls(pfm, embedding_dim=DIM, num_users=N_USERS,
                num_items=N_ITEMS, n_layers=2, edge_users=eu, edge_items=ei,
                edge_coefs=c, device="cpu",
                generator=torch.Generator().manual_seed(4), **extra)
        trainers.append(Trainer(
            m, lambda o, b: get_matching_loss("PairwiseLogisticLoss")(o),
            TrainerConfig(learning_rate=1e-2, seed=3), device="cpu"))
    fused = trainers[0].train_steps_fused(
        {k: np.stack([b[k] for b in batches]) for k in batches[0]})
    eager = torch.stack([trainers[1].train_step(b) for b in batches])
    assert torch.equal(fused, eager)
    for (n, a), b in zip(trainers[0].model.state_dict().items(),
                         trainers[1].model.state_dict().values()):
        assert torch.equal(a, b), n


def test_emb_init_scheme():
    _, pfm = _maps()
    kw = dict(embedding_dim=DIM, num_users=N_USERS, num_items=N_ITEMS,
              device="cpu")
    for scheme in ("normal", "xavier_uniform", "xavier_normal"):
        m = pgraph.LightGCN(pfm, emb_init_scheme=scheme, **kw)
        assert m.emb_user.shape == (N_USERS, DIM)
    assert float(pgraph.LightGCN(pfm, **kw).emb_item.detach().std()) < 1e-3
    with pytest.raises(ValueError, match="emb_init_scheme"):
        pgraph.NGCF(pfm, emb_init_scheme="xavier", **kw)
