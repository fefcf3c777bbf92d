"""The port's sequence CTR models against the JAX package's, on the CPU.

Dice and `TargetAttention` alone, then DIN (Dice attention, and a relu
one under a softmax), BST, DIEN (with ``auxiliary_logits`` on a
``neg_hist`` column and on the batch-rolled fallback) and DSIN over one
schema: a user field, the candidate ``item_id`` and a pre-padded 6-long
``hist`` sharing its table (PAD = the last row), dim 4, batch 32. The
flax params and ``batch_stats`` move over by `interop.from_jax_params`.
Compared: eval-mode logits (normalized by the running statistics), the
training-mode logits and the gradients of the BCE loss (Dice on the
batch's statistics), one step of each package's dense `Trainer` under
Adam (the losses and the weights), and three SGD steps (the Dice
statistics, which move only in training mode, and the eval logits after
them). Then JAX's `test_din_learns_membership` protocol on the port.

Tolerances: f32 logits rtol 1e-5 (atol 1e-6); gradients rtol 1e-4 (atol
1e-6); one Adam step (lr 1e-2) by SASRec's rule, `check_adam_state`: an
element whose true gradient is 0 moves by rounding noise times lr / eps,
so at most 1% of the elements beyond 2e-5 + 1e-4 relative, none beyond
2 lr (elements whose gradient is below the gradients' atol, 1e-6, held
to 2 lr alone);
Dice statistics and eval logits after 3 SGD steps rtol 1e-4 (atol 1e-5).
The statistics are held under SGD: a Dense's bias feeds each Dice's
BatchNorm, and Adam moves a bias whose true gradient is ~0 by each
package's rounding noise (`tests/test_torch_ctr_zoo.py`).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.ranking import sequence_ctr as J
from recbox_tpu.nn.attention import TargetAttention as JTargetAttention
from recbox_tpu.nn.core import Dice as JDice
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.data import ArrayLoader
from recbox_tpu_torch.evaluation import CTREvaluator
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.ranking import sequence_ctr as P
from recbox_tpu_torch.nn import Dice, TargetAttention
from recbox_tpu_torch.nn.core import get_activation
from recbox_tpu_torch.ops.losses import binary_crossentropy
from recbox_tpu_torch.training import Trainer, TrainerConfig

DIM, L, B, V, NU = 4, 6, 32, 15, 5

CASES = [
    ("DIN", dict(attention_hidden_units=(6, 4), hidden_units=(8,))),
    ("DIN", dict(attention_hidden_units=(6,), attention_activation="relu",
                 attention_use_softmax=True, hidden_units=(8,))),
    ("BST", dict(n_layers=1, n_heads=2, hidden_units=(8,))),
    ("DIEN", dict(gru_hidden=DIM, hidden_units=(8,))),
    ("DSIN", dict(session_count=2, n_heads=2, hidden_units=(8,))),
]
IDS = ["DIN-dice", "DIN-softmax-relu", "BST", "DIEN", "DSIN"]


def _specs(S, neg=False):
    specs = (S("user", "categorical", vocab_size=NU, embedding_dim=DIM),
             S("item_id", "categorical", vocab_size=V + 1,
               embedding_dim=DIM),
             S("hist", "sequence", vocab_size=V + 1, embedding_dim=DIM,
               max_len=L, padding_idx=V, share_embedding="item_id"))
    if neg:
        specs += (S("neg_hist", "sequence", vocab_size=V + 1,
                    embedding_dim=DIM, max_len=L, padding_idx=V,
                    share_embedding="item_id"),)
    return specs


def _batch(seed, b=B, neg=False):
    """Pre-padded histories (0 to L - 1 PADs at the front, one row all PAD),
    targets half from the history; click = target in history."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, V, (b, L)).astype(np.int32)
    pads = rng.integers(0, L, b)
    pads[0] = L
    hist[np.arange(L)[None, :] < pads[:, None]] = V
    pick = hist[np.arange(b), rng.integers(0, L, b)]
    target = np.where((rng.random(b) < 0.5) & (pick != V), pick,
                      rng.integers(0, V, b)).astype(np.int32)
    batch = {"user": rng.integers(0, NU, b).astype(np.int32),
             "item_id": target, "hist": hist,
             "click": (hist == target[:, None]).any(1).astype(np.float32)}
    if neg:
        batch["neg_hist"] = np.where(hist == V, V, rng.integers(
            0, V, (b, L))).astype(np.int32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _models(name, kw, neg=False):
    jfm = JFeatureMap("s", _specs(JFeatureSpec, neg), labels=("click",))
    pfm = FeatureMap("s", _specs(FeatureSpec, neg), labels=("click",))
    kw = dict(kw, embedding_dim=DIM)
    return (getattr(J, name)(feature_map=jfm, **kw),
            getattr(P, name)(pfm, device="cpu", **kw))


def _transplant(jm, pm, batch):
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), batch))
    # move the statistics off their zeros / ones so eval mode reads them
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: a + 0.1 * np.arange(a.size, dtype=a.dtype) / a.size,
            variables["batch_stats"])
    pm.load_state_dict(from_jax_params(variables, pm))
    return variables


def check_adam_state(pm, variables, lr, grads=None):
    """The port's state after one Adam step against JAX's (``variables``):
    Adam's first update is lr · g / (|g| + eps), so an element whose true
    gradient is 0 (a key bias under the softmax, an embedding row's
    near-zero entries) moves by anything in [-lr, lr] on rounding noise;
    at most 1% of the elements beyond 2e-5 + 1e-4 relative, none beyond
    2 lr (SASRec's rule, `tests/test_torch_sequential_zoo.py`). With
    ``grads`` (JAX's gradients of the step, a state dict), the elements
    whose gradient is below 1e-6, the gradient checks' own atol, are held
    to 2 lr alone: the update's difference there is lr / 4 times the
    gradients' relative difference, and at that size the gradients agree
    only to their atol."""
    expect = from_jax_params(variables, pm)
    n = bad = 0
    for k, v in pm.state_dict().items():
        err = np.abs(v.numpy() - expect[k].numpy())
        assert float(err.max()) <= 2 * lr, k
        held = err > 2e-5 + 1e-4 * np.abs(expect[k].numpy())
        if grads is not None and k in grads:
            held &= np.abs(grads[k].numpy()) >= 1e-6
        n += err.size
        bad += int(np.sum(held))
    assert bad <= 0.01 * n, (bad, n)


def test_dice_forward_and_statistics_match_jax():
    """Dice over (B, L, H): the statistics over every leading axis, moved
    only in training mode; alpha carried over; get_activation('dice')
    raises as JAX's does."""
    x = np.random.default_rng(1).normal(1.0, 2.0, (8, 5, 3)).astype(
        np.float32)
    jm = JDice()
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), x))
    variables["params"]["alpha"] = np.array([0.3, -0.5, 1.0], np.float32)
    pm = Dice(3, device="cpu")
    holder = torch.nn.Module()
    holder.dice = torch.nn.ModuleList([pm])
    holder.load_state_dict(from_jax_params(
        {"params": {"Dice_0": variables["params"]},
         "batch_stats": {"Dice_0": variables["batch_stats"]}}, holder))
    jout, upd = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    out = pm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    stats = _np_tree(upd["batch_stats"])["BatchNorm_0"]
    np.testing.assert_allclose(pm.BatchNorm_0.mean.numpy(), stats["mean"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pm.BatchNorm_0.var.numpy(), stats["var"],
                               rtol=1e-5, atol=1e-7)
    pm.eval()
    before = pm.BatchNorm_0.mean.clone()
    np.testing.assert_allclose(
        pm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply({"params": variables["params"], **_np_tree(upd)},
                            x)), rtol=1e-5, atol=1e-6)
    assert torch.equal(before, pm.BatchNorm_0.mean)
    assert not any(n.endswith(("scale", "bias")) for n, _ in
                   pm.named_parameters())
    with pytest.raises(ValueError, match="Dice"):
        get_activation("dice")


@pytest.mark.parametrize("softmax,act", [(False, "dice"), (True, "dice"),
                                         (True, "relu")])
def test_target_attention_matches_jax(softmax, act):
    """Masked scores are 0 without the softmax and -1e9 with it."""
    rng = np.random.default_rng(2)
    t = rng.normal(size=(6, DIM)).astype(np.float32)
    seq = rng.normal(size=(6, L, DIM)).astype(np.float32)
    mask = rng.random((6, L)) < 0.6
    mask[0] = False
    jm = JTargetAttention(hidden_units=(5, 3), activation=act,
                          use_softmax=softmax)
    variables = _np_tree(jm.init(jax.random.PRNGKey(3), t, seq, mask))
    pm = TargetAttention(DIM, (5, 3), act, softmax, device="cpu")
    pm.load_state_dict(from_jax_params(variables, pm))
    ts, ss, ms = map(torch.from_numpy, (t, seq, mask))
    for train in (False, True):
        pm.train(train)
        if train:
            jout, _ = jm.apply(variables, t, seq, mask, train=True,
                               mutable=["batch_stats"])
        else:
            jout = jm.apply(variables, t, seq, mask)
        np.testing.assert_allclose(pm(ts, ss, ms).detach().numpy(),
                                   np.asarray(jout), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_forward_grads_and_one_adam_step_match_jax(name, kw):
    neg = name == "DIEN"
    jm, pm = _models(name, kw, neg)
    batch = _batch(0, neg=neg)
    variables = _transplant(jm, pm, batch)
    params = variables["params"]
    stats = {k: v for k, v in variables.items() if k != "params"}
    tb = _tb(batch)
    pm.eval()
    np.testing.assert_allclose(pm(tb).detach().numpy(),
                               np.asarray(jm.apply(variables, batch)),
                               rtol=1e-5, atol=1e-6)

    def jloss(p):
        out = jm.apply({"params": p, **stats}, batch, train=True,
                       mutable=["batch_stats"])[0]
        return jbce(out, batch["click"]), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    pm.train()
    out = pm(tb)
    assert out.shape == (B,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    loss = binary_crossentropy(out, tb["click"])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    expect = from_jax_params({"params": _np_tree(jg), **stats}, pm)
    named = dict(pm.named_parameters())
    assert set(expect) == set(named) | {n for n, _ in pm.named_buffers()}
    for k in named:
        g = expect[k]
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    pm.zero_grad()
    # one Adam step of each package's Trainer from the same state
    pm.load_state_dict(from_jax_params(variables, pm))
    cfg = dict(learning_rate=1e-2, monitor="AUC")
    jt = JTrainer(jm, lambda o, b: jbce(o, b["click"]),
                  JTrainerConfig(**cfg))
    jt.init(batch)
    jt.params = jax.tree_util.tree_map(jnp.asarray, params)
    jt.opt_state = jt.tx.init(jt.params)
    if stats:
        jt.model_state = jax.tree_util.tree_map(jnp.asarray, stats)
    pt = Trainer(pm, lambda o, b: binary_crossentropy(o, b["click"]),
                 TrainerConfig(**cfg), device="cpu")
    step = _batch(1, neg=neg)
    np.testing.assert_allclose(float(pt.train_step(step)),
                               float(jt.train_step(step)), rtol=1e-5)
    check_adam_state(pm, {"params": _np_tree(jt.params),
                          **_np_tree(jt.model_state)}, 1e-2)


@pytest.mark.parametrize("name,kw", [c for c in CASES if c[0] != "BST"],
                         ids=[i for i in IDS if i != "BST"])
def test_dice_statistics_follow_jax_under_sgd(name, kw):
    """Three SGD steps move every Dice's statistics as JAX's
    ``batch_stats``; eval logits (normalized by them) agree after; the
    statistics ride the trainer's model state and a state dict."""
    neg = name == "DIEN"
    jm, pm = _models(name, kw, neg)
    batch = _batch(3, neg=neg)
    cfg = dict(optimizer="sgd", learning_rate=0.5, monitor="AUC")
    jt = JTrainer(jm, lambda o, b: jbce(o, b["click"]),
                  JTrainerConfig(**cfg))
    jt.init(batch)
    has_stats = "batch_stats" in jt.model_state
    assert has_stats == (kw.get("attention_activation", "dice") == "dice"
                         or name == "DIEN")
    pm.load_state_dict(from_jax_params(
        {"params": _np_tree(jt.params), **_np_tree(jt.model_state)}, pm))
    pt = Trainer(pm, lambda o, b: binary_crossentropy(o, b["click"]),
                 TrainerConfig(**cfg), device="cpu")
    pt.init(batch)
    assert set(pt.model_state) == {n for n, _ in pm.named_buffers()}
    for step in range(3):
        b = _batch(10 + step, neg=neg)
        np.testing.assert_allclose(float(pt.train_step(b)),
                                   float(jt.train_step(b)), rtol=1e-5)
    expect = from_jax_params({"params": _np_tree(jt.params),
                              **_np_tree(jt.model_state)}, pm)
    for k, v in pt.model_state.items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    test = _batch(20, neg=neg)
    np.testing.assert_allclose(pt.apply(test).numpy(),
                               np.asarray(jt.apply(test)), rtol=1e-4,
                               atol=1e-5)
    if has_stats:
        assert set(pt.state_dict()["model_state"]) == set(pt.model_state)


def test_dien_auxiliary_logits_match_jax():
    """On the ``neg_hist`` column, and on the batch-rolled history when a
    batch has none."""
    jm, pm = _models("DIEN", dict(gru_hidden=DIM, hidden_units=(8,)),
                     neg=True)
    batch = _batch(4, neg=True)
    variables = _transplant(jm, pm, batch)
    for b in (batch, {k: v for k, v in batch.items() if k != "neg_hist"}):
        want = jm.apply(variables, b, method=jm.auxiliary_logits)
        got = pm.auxiliary_logits(_tb(b))
        assert got.shape == (B, L - 1, 2)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_faults_raise_value_error():
    """Where JAX asserts or raises: DIEN's widths, DSIN's sessions."""
    pfm = FeatureMap("s", _specs(FeatureSpec), labels=("click",))
    with pytest.raises(ValueError, match="gru_hidden"):
        P.DIEN(pfm, embedding_dim=DIM, gru_hidden=DIM + 1, device="cpu")
    with pytest.raises(ValueError, match="session_count"):
        P.DSIN(pfm, embedding_dim=DIM, session_count=4, device="cpu")


def test_dsin_flip_sequences_is_flax():
    """`flip_sequences` reverses each row's valid prefix, as flax's."""
    from flax.linen.recurrent import flip_sequences as jflip
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    lens = np.array([2, 5], np.int32)
    want = jflip(x, lens, num_batch_dims=1, time_major=False)
    got = P.flip_sequences(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_din_learns_membership():
    """JAX's `test_din_learns_membership` on the port: click iff the target
    is in the history (5000 rows, vocab 64, L = 8, pre-padded), DIN with a
    32-wide relu attention, Adam 1e-2, 10 epochs of batch 256: held-out
    AUC > 0.9."""
    from tests.test_sequence_ctr import make_din_data
    rng = np.random.default_rng(9)
    jfm, arrays = make_din_data(rng)
    fm = FeatureMap("din", tuple(FeatureSpec(**vars(s))
                                 for s in jfm.features), labels=("click",))
    split = int(len(arrays["click"]) * 0.85)
    train = {k: v[:split] for k, v in arrays.items()}
    valid = {k: v[split:] for k, v in arrays.items()}
    model = P.DIN(fm, embedding_dim=16, attention_hidden_units=(32,),
                  attention_activation="relu", hidden_units=(64, 32),
                  generator=torch.Generator().manual_seed(0), device="cpu")
    cfg = TrainerConfig(learning_rate=1e-2, epochs=10, patience=12,
                        monitor="AUC", lr_decay_factor=1.0,
                        reload_best_on_plateau=False)
    tr = Trainer(model, lambda o, b: binary_crossentropy(o, b["click"]),
                 cfg, eval_fn=CTREvaluator(valid, label="click",
                                           metrics=["AUC"]), device="cpu")
    metrics = tr.fit(ArrayLoader(train, batch_size=256, drop_last=True,
                                 seed=2))
    assert metrics["AUC"] > 0.9, metrics
