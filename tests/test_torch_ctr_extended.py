"""The port's extended CTR zoo and DAGFM / KD_DAGFM against the JAX
package's, on the CPU.

The 19 models of `ctr_extended.py` (with HFM+ and circular correlation,
EDCN's Hadamard bridge, EulerNet with its LayerNorms, FLEN with one
group and with three), DAGFM with inner and outer kernels and KD_DAGFM get
the flax params (`interop`) and the same numpy batch: 3 categorical fields
(one with a padding id; sources user / item / context, FLEN's groups) and
a numeric one, dim 4. Compared: the logits, the gradients of the BCE loss
and one step of the port's dense `Trainer` against JAX's trainer
optimizer (`_make_optimizer`: Adam 1e-2, clip 10) on JAX's gradients of
the same batch, JAX's side one jitted program a model; and
`distillation_loss` with and without labels, its gradient reaching the
student only.

Tolerances: logits rtol 1e-5 (atol 1e-6); the loss rtol 1e-5; gradients
rtol 1e-4 (atol 1e-6); the Adam step by SASRec's rule (`check_adam_state`
of `tests/test_torch_sequence_ctr.py`: an element whose true gradient is
0 moves by rounding noise times lr / eps; at most 1% of the elements
beyond 2e-5 + 1e-4 relative, none beyond 2 lr; an element whose step
gradient is below the gradients' atol, 1e-6, is held to 2 lr alone: DeepIM's
third-order weight reads e³ ~ 1e-12 from normal(1e-4) embeddings, whose
gradient the two packages round apart by ~10%). EulerNet with its
LayerNorms (`test_eulernet_layer_norms_match_jax`) is held to JAX within
twice the distance of the port's own f32 logits from its f64 ones: after
a LayerNorm the next layer's log-modulus and phase (atan2) read values
near the origin, and f32 rounding alone moves the logits by ~1e-5 there.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.ranking import ctr_extended as JX
from recbox_tpu.models.ranking import distill as JD
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.training.trainer import TrainerConfig as JTrainerConfig
from recbox_tpu.training.trainer import _make_optimizer as j_make
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models import ranking as P
from recbox_tpu_torch.ops.losses import binary_crossentropy
from recbox_tpu_torch.training import Trainer, TrainerConfig
from test_torch_sequence_ctr import check_adam_state

DIM, B = 4, 48
VOCABS = {"c0": 11, "c1": 7, "c2": 13}
H = (8,)

ZOO = [
    ("FFM", {}),
    ("FwFM", {}),
    ("FmFM", {}),
    ("FEFM", {}),
    ("DeepFEFM", dict(hidden_units=H)),
    ("ONN", dict(hidden_units=H)),
    ("CCPM", dict(conv_kernel_widths=(3, 2), conv_filters=(2, 3),
                  hidden_units=H)),
    ("FGCNN", dict(conv_filters=(2, 3), conv_kernel_widths=(3, 2),
                   new_maps=(2, 1), pooling_widths=(2, 1),
                   hidden_units=H)),
    ("FLEN", dict(hidden_units=H)),
    ("IFM", dict(fen_hidden_units=H)),
    ("DIFM", dict(fen_hidden_units=H, att_dim=3, num_heads=2)),
    ("EDCN", dict(num_layers=2)),
    ("EDCN", dict(num_layers=2, bridge_type="hadamard_product", tau=0.5)),
    ("MLR", dict(num_regions=3)),
    ("FiGNN", dict(gnn_steps=2, num_heads=2)),
    ("EulerNet", dict(order_layers=(5, 3))),
    ("DeepIM", dict(im_order=3, hidden_units=H)),
    ("HFM", {}),
    ("HFM", dict(deep=True, hidden_units=H,
                 interaction_type="circular_correlation")),
    ("DCNMix", dict(num_cross_layers=2, hidden_units=H, low_rank=3,
                    num_experts=2)),
    ("FNN", dict(hidden_units=H)),
    ("DAGFM", dict(n_layers=2)),
    ("DAGFM", dict(n_layers=2, kernel_type="outer", rank=3)),
    ("KD_DAGFM", dict(n_layers=2)),
]
IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}"
       for n, kw in ZOO]


def _specs(S, one_group=False):
    src = (lambda s: "user") if one_group else (lambda s: s)
    return (S("c0", "categorical", vocab_size=VOCABS["c0"],
              embedding_dim=DIM, padding_idx=0, source=src("user")),
            S("c1", "categorical", vocab_size=VOCABS["c1"],
              embedding_dim=DIM, source=src("item")),
            S("c2", "categorical", vocab_size=VOCABS["c2"],
              embedding_dim=DIM, source=src("context")),
            S("n0", "numeric", embedding_dim=DIM, source=src("item")))


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, v, b).astype(np.int32)
             for k, v in VOCABS.items()}
    batch["n0"] = rng.normal(size=b).astype(np.float32)
    batch["click"] = ((batch["c1"] % 2 == 0) ^ (batch["c2"] < 5)).astype(
        np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _jclass(name):
    return getattr(JD if name in ("DAGFM", "KD_DAGFM") else JX, name)


def _models(name, kw, one_group=False):
    jfm = JFeatureMap("t", _specs(JFeatureSpec, one_group),
                      labels=("click",))
    pfm = FeatureMap("t", _specs(FeatureSpec, one_group), labels=("click",))
    kw = dict(kw, embedding_dim=DIM)
    return (_jclass(name)(feature_map=jfm, **kw),
            getattr(P, name)(pfm, device="cpu", **kw))


def _jax_steps(jm, params, batches, lr=1e-2):
    """JAX's loss, logits and gradients on each of ``batches`` (one jitted
    program), and its params after one step of the trainer's optimizer
    (`_make_optimizer`: clip 10, Adam) on the last."""
    def loss(p, b):
        out = jm.apply({"params": p}, b)
        return jbce(out, b["click"]), out

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    res = [vg(params, b) for b in batches]
    tx = j_make(JTrainerConfig(learning_rate=lr))
    grads = res[-1][1]
    updates, _ = tx.update(grads, tx.init(params), params)
    return res, optax.apply_updates(params, updates)


def _check(name, kw, one_group=False):
    jm, pm = _models(name, kw, one_group)
    batch, step = _batch(0), _batch(1)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), batch))["params"]
    pm.load_state_dict(from_jax_params(params, pm))
    (((jl, jout), jg), ((jl_step, _), step_grads)), stepped = _jax_steps(
        jm, params, [batch, step])
    tb = _tb(batch)
    out = pm(tb)
    assert out.shape == (B,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    loss = binary_crossentropy(out, tb["click"])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    expect = from_jax_params(_np_tree(jg), pm)
    named = dict(pm.named_parameters())
    assert set(expect) == set(named)
    for k, g in expect.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    pm.zero_grad()
    pt = Trainer(pm, lambda o, b: binary_crossentropy(o, b["click"]),
                 TrainerConfig(learning_rate=1e-2, monitor="AUC"),
                 device="cpu")
    np.testing.assert_allclose(float(pt.train_step(step)), float(jl_step),
                               rtol=1e-5)
    check_adam_state(pm, _np_tree(stepped), 1e-2,
                     from_jax_params(_np_tree(step_grads), pm))


@pytest.mark.parametrize("name,kw", ZOO, ids=IDS)
def test_extended_zoo_forward_grads_and_one_step_match_jax(name, kw):
    _check(name, kw)


def test_flen_with_one_group_matches_jax():
    """One source: no inter-group weights, the MF part zeros."""
    _check("FLEN", dict(hidden_units=H), one_group=True)
    _, pm = _models("FLEN", dict(hidden_units=H), one_group=True)
    assert not hasattr(pm, "mf_weight")


def test_eulernet_layer_norms_match_jax():
    """EulerNet with ``apply_norm``: the LayerNorms compute flax's fast
    variance, E[x²] − E[x]² (`nn.attention.LayerNorm(fast_variance=True)`);
    the logits agree with JAX's within twice the port's own f32 error (its
    distance from the same model in f64)."""
    from flax.linen import LayerNorm as JLayerNorm
    from recbox_tpu_torch.nn.attention import LayerNorm
    x = (np.random.default_rng(7).normal(size=(6, 5, 8)) * 0.05
         + 3.0).astype(np.float32)
    jln = JLayerNorm()
    ln_params = _np_tree(jln.init(jax.random.PRNGKey(0), x))
    ln = LayerNorm(8, device="cpu", fast_variance=True)
    ln.load_state_dict(from_jax_params(ln_params, ln))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jln.apply(ln_params, x)),
                               rtol=1e-5, atol=1e-5)
    for layers in ((3,), (5, 3)):
        jm, pm = _models("EulerNet", dict(order_layers=layers,
                                          apply_norm=True))
        batch = _batch(0)
        params = _np_tree(jm.init(jax.random.PRNGKey(0), batch))["params"]
        pm.load_state_dict(from_jax_params(params, pm))
        want = np.asarray(jm.apply({"params": params}, batch))
        tb = _tb(batch)
        got = pm(tb).detach().numpy()
        tb64 = {k: v.double() if v.is_floating_point() else v
                for k, v in tb.items()}
        f64 = pm.double()(tb64).detach().numpy()
        own = float(np.max(np.abs(got - f64)))
        assert 0 < own < 1e-4, own
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * own)


def test_linear_module_where_jax_has_one():
    """The packed trainer plans the same packs as JAX's: ``linear`` only
    in the models whose JAX counterpart reads a first-order term."""
    without = {"MLR", "FiGNN", "EulerNet", "DeepIM", "DCNMix", "FNN",
               "DAGFM", "KD_DAGFM"}
    for name, kw in ZOO:
        _, pm = _models(name, kw)
        assert hasattr(pm, "linear") == (name not in without), name
        assert hasattr(pm, "ffm_embedding") == (name in ("FFM", "ONN"))
        assert hasattr(pm, "embedding") == (name != "FFM"), name


@pytest.mark.parametrize("with_labels", [False, True])
def test_distillation_loss_matches_jax(with_labels):
    """KD_DAGFM's schedule: α · MSE against a DCNv2 teacher's logits
    (+ (1 − α) · BCE with labels); the teacher gets no gradient."""
    from recbox_tpu.models.ranking.ctr import DCNv2 as JDCNv2
    jm, pm = _models("KD_DAGFM", dict(n_layers=2))
    jfm = JFeatureMap("t", _specs(JFeatureSpec), labels=("click",))
    pfm = FeatureMap("t", _specs(FeatureSpec), labels=("click",))
    teacher_kw = dict(embedding_dim=DIM, num_cross_layers=2, hidden_units=H)
    jteacher = JDCNv2(feature_map=jfm, **teacher_kw)
    pteacher = P.DCNv2(pfm, device="cpu", **teacher_kw)
    batch = _batch(5)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), batch))["params"]
    tparams = _np_tree(jteacher.init(jax.random.PRNGKey(1), batch))["params"]
    pm.load_state_dict(from_jax_params(params, pm))
    pteacher.load_state_dict(from_jax_params(tparams, pteacher))
    labels = batch["click"] if with_labels else None

    def jloss(p, tp):
        return JD.distillation_loss(
            jm.apply({"params": p}, batch),
            jteacher.apply({"params": tp}, batch),
            None if labels is None else jnp.asarray(labels), alpha=0.7)

    jl, (jg, jtg) = jax.value_and_grad(jloss, argnums=(0, 1))(params,
                                                              tparams)
    assert all(float(np.abs(g).max()) == 0.0
               for g in jax.tree_util.tree_leaves(jtg))
    tb = _tb(batch)
    loss = P.distillation_loss(
        pm(tb), pteacher(tb),
        None if labels is None else tb["click"], alpha=0.7)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    assert all(p.grad is None for p in pteacher.parameters())
    expect = from_jax_params(_np_tree(jg), pm)
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expect[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
