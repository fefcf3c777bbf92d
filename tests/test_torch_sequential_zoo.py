"""The port's sequential zoo against the JAX package's, on the CPU.

The 20 models beside SASRec (GRU4Rec, NARM, STAMP, Caser, NextItNet, the
13 of `extended.py` and the two session-graph models) at d = 16, L = 8,
1-2 layers, V = 50 (49 items and PAD), dropout 0: the same numpy batch
through both packages, the flax params carried over by
`interop.from_jax_params`. JAX runs each model once per case (module
cache); the tests read its results.

Tolerances: f32 `full_scores` and `user_tower` within rtol 1e-5 (atol
1e-6 of the largest value: other summation orders); gradients of the
full-softmax CE within rtol 1e-4 (atol 1e-4 of the largest gradient: a
gradient that is zero in exact arithmetic comes out as rounding noise on
both sides); one Adam step (optax's chain through JAX's
`_make_optimizer`) with SASRec's rule (`tests/test_torch_sequential.py`):
Adam's first update is lr · g / (|g| + 1e-8), so an element whose
gradient is rounding noise may move anywhere in [−lr, lr]; at most 1% of
the elements beyond 2e-5 + 1e-4 relative, none beyond 2 lr. bf16 compute
(BERT4Rec, CORE, FDSA, GCSAN): `full_scores` within JAX's own bf16 bound
for the family, 0.05 of the largest f32 score
(`tests/test_sequential_extended.py:186-210`). BERT4Rec's
`fused_cloze_loss` runs B2's plain version here and JAX's kernel in
Pallas interpret mode: the loss within 1e-3 relative and the gradients
within 0.5% of their largest entry (B2's bounds, `PERF.md` §6 /
`ROADMAP.md` Queue C #7).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.sequential import extended as jext
from recbox_tpu.models.sequential import models as jseq
from recbox_tpu.models.sequential import session_graph as jsg
from recbox_tpu.ops import full_softmax_loss as jfull_softmax_loss
from recbox_tpu.training.trainer import TrainerConfig as JTrainerConfig
from recbox_tpu.training.trainer import _make_optimizer as j_make
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models import sequential as P
from recbox_tpu_torch.models.reranking.models import DLCM
from recbox_tpu_torch.ops.losses import full_softmax_loss
from recbox_tpu_torch.training import Trainer, TrainerConfig

V, DIM, L, B, NU, FV = 50, 16, 8, 12, 9, 7

CASES = {
    "GRU4Rec": (jseq, dict(hidden_size=12, n_layers=2)),
    "NARM": (jseq, dict(hidden_size=12)),
    "STAMP": (jseq, {}),
    "Caser": (jseq, dict(n_h=4, n_v=3, heights=(2, 3))),
    "NextItNet": (jseq, dict(dilations=(1, 2), kernel_size=3)),
    "BERT4Rec": (jext, dict(n_layers=2, n_heads=2)),
    "FPMC": (jext, dict(num_users=NU)),
    "TransRec": (jext, dict(num_users=NU)),
    "HGN": (jext, dict(num_users=NU)),
    "SHAN": (jext, dict(num_users=NU, short_len=3)),
    "FOSSIL": (jext, dict(num_users=NU, order_k=2)),
    "HRM": (jext, dict(num_users=NU, high_order=3)),
    "NPE": (jext, dict(num_users=NU)),
    "CORE": (jext, dict(n_layers=1, n_heads=2)),
    "LightSANs": (jext, dict(n_layers=2, n_heads=2, k_interests=3)),
    "FDSA": (jext, dict(n_layers=1, n_heads=2, feature_vocab=FV)),
    "RepeatNet": (jext, dict(hidden_size=12)),
    "SINE": (jext, dict(prototype_num=10, interest_num=2)),
    "SRGNN": (jsg, dict(steps=2)),
    "GCSAN": (jsg, dict(steps=1, n_layers=1, n_heads=2)),
}
BF16 = ("BERT4Rec", "CORE", "FDSA", "GCSAN")


def _fm(FM, FS):
    return FM("seq", (FS("item_id", "categorical", source="item",
                         vocab_size=V, embedding_dim=DIM),),
              query_index="user_id", corpus_index="item_id", num_items=V)


def _batch(seed=0, b=B):
    """Left-padded histories of random lengths over a small item range (so
    sessions repeat items), a full row, a one-item row; users, features,
    next-item targets."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, b).astype(np.int32)
    lens[0], lens[1] = L, 1
    seq = rng.integers(1, 12, (b, L)).astype(np.int32)
    seq[np.arange(L)[None, :] < (L - lens)[:, None]] = 0
    feat = np.where(seq > 0, rng.integers(1, FV, (b, L)), 0).astype(np.int32)
    return {"item_seq": seq, "seq_len": lens,
            "user_id": rng.integers(0, NU, b).astype(np.int32),
            "feat_seq": feat,
            "item_id": rng.integers(1, V, b).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _kw(name, compute_dtype="float32"):
    return dict(embedding_dim=DIM, max_seq_len=L, dropout=0.0,
                compute_dtype=compute_dtype, **CASES[name][1])


def _jmodel(name, compute_dtype="float32"):
    mod = CASES[name][0]
    return getattr(mod, name)(feature_map=_fm(JFeatureMap, JFeatureSpec),
                              **_kw(name, compute_dtype))


def _pmodel(name, params, compute_dtype="float32"):
    pm = getattr(P, name)(_fm(FeatureMap, FeatureSpec), device="cpu",
                          **_kw(name, compute_dtype))
    pm.load_state_dict(from_jax_params(params, pm))
    return pm


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX's params, user_tower, full_scores, CE loss and gradients, and
    the params after one Adam step, on `_batch(0)`: one jitted program."""
    jm = _jmodel(name)
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    tx = j_make(JTrainerConfig(learning_rate=1e-3))

    def run(key):
        params = fnn.meta.unbox(jm.init(key, batch,
                                        method=jm.full_scores)["params"])

        def loss(p):
            s = jm.apply({"params": p}, batch, method=jm.full_scores)
            return jfull_softmax_loss(s, batch["item_id"]), s

        (value, scores), grads = jax.value_and_grad(loss, has_aux=True)(
            params)
        upd, _ = tx.update(grads, tx.init(params), params)
        out = {"params": params, "full_scores": scores, "loss": value,
               "grads": grads, "stepped": optax.apply_updates(params, upd)}
        if name != "RepeatNet":
            out["user_tower"] = jm.apply({"params": params}, batch,
                                         method=jm.user_tower)
        return out

    return _np_tree(jax.jit(run)(jax.random.PRNGKey(3)))


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want, np.float32)
    top = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol_rel * top)


def check_forward(name):
    ref = _jax(name)
    pm = _pmodel(name, ref["params"])
    tb = _tb(_batch(0))
    with torch.no_grad():
        _close(pm.full_scores(tb), ref["full_scores"], 1e-5, 1e-6)
        if name == "RepeatNet":
            with pytest.raises(NotImplementedError, match="full_scores"):
                pm.user_tower(tb)
        else:
            _close(pm.user_tower(tb), ref["user_tower"], 1e-5, 1e-6)


def check_ce_gradients(name):
    ref = _jax(name)
    pm = _pmodel(name, ref["params"])
    tb = _tb(_batch(0))
    loss = full_softmax_loss(pm.full_scores(tb), tb["item_id"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref["loss"]),
                               rtol=1e-5)
    expect = from_jax_params(ref["grads"], pm)
    named = dict(pm.named_parameters())
    assert set(expect) == set(named)
    top = max(float(g.abs().max()) for g in expect.values())
    for k, g in expect.items():
        got = named[k].grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-4 * top, err_msg=k)


def check_adam_step(name):
    ref = _jax(name)
    pm = _pmodel(name, ref["params"])
    t = Trainer(pm, lambda o, b: full_softmax_loss(o, b["item_id"]),
                TrainerConfig(learning_rate=1e-3), device="cpu",
                train_method="full_scores")
    t.train_step(_batch(0))
    expect = from_jax_params(ref["stepped"], pm)
    n = bad = 0
    for k, v in pm.state_dict().items():
        err = np.abs(v.numpy() - expect[k].numpy())
        assert float(err.max()) <= 2e-3, k
        n += err.size
        bad += int(np.sum(err > 2e-5 + 1e-4 * np.abs(expect[k].numpy())))
    assert bad <= 0.01 * n, (bad, n)


def check_bf16_compute(name):
    ref = _jax(name)
    jm = _jmodel(name, "bfloat16")
    batch = _batch(0)
    want = np.asarray(jm.apply({"params": ref["params"]}, batch,
                               method=jm.full_scores))
    pm = _pmodel(name, ref["params"], "bfloat16")
    with torch.no_grad():
        got = pm.full_scores(_tb(batch)).numpy()
    top = float(np.max(np.abs(ref["full_scores"])))
    assert float(np.max(np.abs(got - want))) < 0.05 * top
    assert float(np.max(np.abs(got - ref["full_scores"]))) < 0.05 * top


# -- this file: the encoders of models.py and the session-graph models;
# test_torch_seq_zoo_attention.py and test_torch_seq_zoo_shallow.py take
# the rest of the zoo through the checks above
HERE = ("GRU4Rec", "NARM", "STAMP", "Caser", "NextItNet", "SRGNN", "GCSAN")


@pytest.mark.parametrize("name", HERE)
def test_forward_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", HERE)
def test_ce_gradients_match_jax(name):
    check_ce_gradients(name)


@pytest.mark.parametrize("name", HERE)
def test_adam_step_matches_jax(name):
    check_adam_step(name)


def test_bf16_compute_matches_jax():
    check_bf16_compute("GCSAN")


def test_session_adjacency_matches_jax():
    """On right-padded sessions with repeated items and transitions."""
    seq = np.array([[1, 2, 1, 2, 3, 0, 0, 0], [4, 4, 4, 5, 0, 0, 0, 0],
                    [7, 8, 9, 7, 8, 9, 7, 1], [3, 0, 0, 0, 0, 0, 0, 0],
                    [0] * 8], np.int32)
    want = jsg.session_adjacency(jnp.asarray(seq))
    got = P.session_adjacency(torch.from_numpy(seq))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-7)


def test_caser_kernels_keep_flax_layout():
    """flax's NHWC kernels (h, D, 1, n_h) and (L, 1, 1, n_v) become the
    (n_h, 1, h, D) and (n_v, 1, L, 1) weights of the port's Conv2d: one
    output of each filter by hand against the port's convolution."""
    ref = _jax("Caser")
    pm = _pmodel("Caser", ref["params"])
    k3 = ref["params"]["caser"]["hconv3"]["kernel"]           # (3, D, 1, 4)
    vk = ref["params"]["caser"]["vconv"]["kernel"]            # (L, 1, 1, 3)
    assert k3.shape == (3, DIM, 1, 4) and vk.shape == (L, 1, 1, 3)
    emb = np.random.default_rng(0).normal(size=(1, L, DIM)).astype(
        np.float32)
    img = torch.from_numpy(emb)[:, None]
    with torch.no_grad():
        h = pm.caser.hconv3(img).numpy()                      # (1, 4, L-2, 1)
        v = pm.caser.vconv(img).numpy()                       # (1, 3, 1, D)
    b3 = ref["params"]["caser"]["hconv3"]["bias"]
    np.testing.assert_allclose(
        h[0, 2, 1, 0], np.sum(emb[0, 1:4] * k3[:, :, 0, 2]) + b3[2],
        rtol=1e-5)
    bv = ref["params"]["caser"]["vconv"]["bias"]
    np.testing.assert_allclose(
        v[0, 1, 0, 5], np.sum(emb[0, :, 5] * vk[:, 0, 0, 1]) + bv[1],
        rtol=1e-5)


def test_dlcm_runs_on_the_shared_cell():
    """DLCM's GRU is `nn.recurrent`'s: its cell is that class and the
    reranker still scores every slot."""
    from recbox_tpu_torch.nn.recurrent import GRUCell
    m = DLCM(5, hidden_size=6, device="cpu")
    assert isinstance(m.GRUCell_0, GRUCell)
    out = m(torch.randn(2, 4, 5), torch.ones(2, 4, dtype=torch.bool))
    assert out.shape == (2, 4) and torch.isfinite(out).all()
