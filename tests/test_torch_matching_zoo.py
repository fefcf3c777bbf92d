"""The matching zoo of the port against the JAX package, on the CPU.

Neural CF (`models/matching/neural_cf.py`): NeuMF, ConvNCF, FISM, NAIS,
ENMF and NNCF on the JAX model's initial params (every port parameter
transplanted by `interop.from_jax_params`, none left at its own draw;
dropout 0): the training scores of a (B, S) candidate batch, `full_scores`
and the gradients of a weighted sum of the scores (ENMF: of `enmf_loss`
over `all_scores_and_parts`) against JAX's, f32, rtol 1e-5 (values also
within 1e-5 of the tensor's largest entry: products and sums in another
order).

The traditional models (`models/matching/traditional.py`), fit on the
same interactions, `full_scores` over every user against JAX's:
- Pop exactly; ItemKNN (top-10 neighbours and all) and NCEPLRec within
  rtol 1e-5 (f32 products of the same numbers; NCEPLRec's SVD is the same
  numpy float64 call on both sides);
- PureSVD within rtol 1e-4 of the largest score (the same numpy SVD; the
  scores, not the factors, whose signs are the SVD's);
- EASE and ADMM-SLIM within 1e-4 of the largest score: their inverses are
  float64 here and float32 in JAX (~1e-5 relative apart);
- SLIM within 1e-4 of the largest score (30 coordinate-descent passes in
  float32, each dot product summed in another order).
`topk_items` with seen items masked gives JAX's ids, the items tied with
the k-th aside (items with equal columns score alike), and its scores
within rtol 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.knowledge.models import StaticArray
from recbox_tpu.models.matching import neural_cf as jncf
from recbox_tpu.models.matching import traditional as jtrad
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.matching import neural_cf as pncf
from recbox_tpu_torch.models.matching import traditional as ptrad
from tests.test_torch_retrieval import _sets_equal_but_ties

N_USERS, N_ITEMS, DIM, B, S, L = 12, 15, 8, 6, 4, 5
RTOL = 1e-5


def _maps():
    specs = [("user_id", "user", N_USERS), ("item_id", "item", N_ITEMS)]
    kw = dict(query_index="user_id", corpus_index="item_id",
              num_items=N_ITEMS)
    return (JFeatureMap("z", tuple(JFeatureSpec(n, "categorical", s,
                                                vocab_size=v,
                                                embedding_dim=DIM)
                                   for n, s, v in specs), **kw),
            FeatureMap("z", tuple(FeatureSpec(n, "categorical", s,
                                              vocab_size=v, embedding_dim=DIM)
                                  for n, s, v in specs), **kw))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, N_ITEMS, (B, L)).astype(np.int32)
    hist[:, 3:] = 0                                   # pads
    hist[0, :] = 0                                    # an empty history
    ids = rng.integers(0, N_ITEMS, (B, S)).astype(np.int32)
    ids[1, 0] = hist[1, 0]                            # a target in its history
    return {"user_id": rng.integers(0, N_USERS, B).astype(np.int32),
            "__item_ids__": ids, "hist": hist}


def _neighbors(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_ITEMS, (N_USERS, 4)).astype(np.int32),
            rng.integers(0, N_USERS, (N_ITEMS, 4)).astype(np.int32))


def _ncf_kwargs(name):
    un, inb = _neighbors()
    return {
        "NeuMF": (dict(mlp_hidden_units=(16, 8)), {}),
        "ConvNCF": (dict(channels=(4, 3)), {}),
        "FISM": (dict(alpha=0.4), {}),
        "NAIS": (dict(beta=0.6, attention_dim=6), {}),
        "ENMF": (dict(dropout=0.0), {}),
        "NNCF": (dict(conv_channels=5, conv_kernel=3,
                      mlp_hidden_units=(12,)),
                 dict(user_neighbors=StaticArray(un),
                      item_neighbors=StaticArray(inb))),
    }[name]


NCF = ["NeuMF", "ConvNCF", "FISM", "NAIS", "ENMF", "NNCF"]


def _pair(name):
    jfm, pfm = _maps()
    kw, jextra = _ncf_kwargs(name)
    common = dict(embedding_dim=DIM, num_users=N_USERS, num_items=N_ITEMS)
    jm = getattr(jncf, name)(feature_map=jfm, **common, **kw, **jextra)
    pextra = {k: v.value for k, v in jextra.items()}
    pm = getattr(pncf, name)(pfm, device="cpu",
                             generator=torch.Generator().manual_seed(9),
                             **common, **kw, **pextra)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    method = jm.all_scores_and_parts if name == "ENMF" else None
    params = jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(
        jm.init(jax.random.PRNGKey(3), jb,
                **({"method": method} if method else {}))["params"]))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    state = from_jax_params(params, pm)
    assert set(state) == set(before)
    pm.load_state_dict(state)
    for k, v in pm.state_dict().items():     # every one moved over
        # (a constant init, zeros or ENMF's h, cannot tell)
        assert not torch.equal(v, before[k]) or v.unique().numel() == 1, k
    return jm, params, pm, batch


def _close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


@pytest.mark.parametrize("name", NCF)
def test_neural_cf_matches_jax(name):
    jm, params, pm, batch = _pair(name)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pm.eval()
    _close(pm(tb).detach(), jm.apply({"params": params}, jb), "scores")
    _close(pm.full_scores(tb).detach(),
           jm.apply({"params": params}, jb, method=jm.full_scores),
           "full_scores")
    w = np.random.default_rng(5).normal(size=(B, S)).astype(np.float32)
    if name == "ENMF":
        mask = batch["hist"] != 0

        def jloss(p):
            return jncf.enmf_loss(*jm.apply({"params": p}, jb,
                                            method=jm.all_scores_and_parts),
                                  jnp.asarray(mask), neg_weight=0.3)

        ploss = pncf.enmf_loss(*pm.all_scores_and_parts(tb),
                               torch.from_numpy(mask), neg_weight=0.3)
        _close(ploss.detach(), jloss(params), "enmf_loss")
    else:
        def jloss(p):
            return jnp.sum(jm.apply({"params": p}, jb) * w)

        ploss = torch.sum(pm(tb) * torch.from_numpy(w))
    jg = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray,
                                                           params))), pm)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(ploss, [p for _, p in pm.named_parameters()],
                                allow_unused=True)
    for n, g in zip(names, grads):
        g = torch.zeros_like(jg[n]) if g is None else g
        _close(g, jg[n].numpy(), n)


def _interactions(seed=2, n_users=40, n_items=30):
    rng = np.random.default_rng(seed)
    ub = rng.integers(0, 3, n_users)
    users, items = [], []
    for u in range(n_users):
        own = np.flatnonzero(np.arange(n_items) % 3 == ub[u])
        chosen = rng.choice(own, rng.integers(3, 8), replace=False)
        users += [u] * len(chosen)
        items += chosen.tolist()
    users.append(0)
    items.append(int(np.flatnonzero(np.arange(n_items) % 3 != ub[0])[0]))
    return np.asarray(users), np.asarray(items), n_users, n_items


TRAD = {
    "Pop": ({}, 0.0),
    "ItemKNN": ({"topk": 10}, RTOL),
    "ItemKNN_all": ({"topk": 0, "shrink": 1.0}, RTOL),
    "EASE": ({"reg_weight": 5.0}, 1e-4),
    "PureSVD": ({"factors": 6}, 1e-4),
    "SLIM": ({"l1_reg": 1e-3, "l2_reg": 1e-2, "n_iters": 10}, 1e-4),
    "ADMMSLIM": ({"lambda1": 0.5, "lambda2": 5.0, "rho": 50.0,
                  "n_iters": 20}, 1e-4),
    "NCEPLRec": ({"rank": 6, "beta": 0.7, "reg_weight": 10.0}, RTOL),
}


@pytest.mark.parametrize("case", list(TRAD), ids=list(TRAD))
def test_traditional_full_scores_match_jax(case):
    name = case.split("_")[0]
    kw, tol = TRAD[case]
    data = _interactions()
    jm = getattr(jtrad, name)(**kw).fit(*data)
    pm = getattr(ptrad, name)(device="cpu", **kw).fit(*data)
    rows = np.arange(data[2])
    want = np.asarray(jm.full_scores(rows))
    got = pm.full_scores(rows)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    if tol == 0.0:
        np.testing.assert_array_equal(got, want)
    elif tol == RTOL:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_topk_items_masks_seen():
    data = _interactions()
    jm = jtrad.NCEPLRec(rank=6).fit(*data)
    pm = ptrad.NCEPLRec(rank=6, device="cpu").fit(*data)
    rows = np.arange(10)
    seen = ptrad.build_interaction_matrix(*data)[rows]
    js, ji = jtrad.topk_items(jm, rows, 5, mask_seen=jnp.asarray(seen))
    ps, pi = ptrad.topk_items(pm, rows, 5, mask_seen=seen)
    assert _sets_equal_but_ties(ps, pi, js, ji)
    np.testing.assert_allclose(ps, js, rtol=RTOL, atol=1e-7)
    assert not seen[np.arange(10)[:, None], pi].any()
