"""The port's CTR zoo against the JAX package's, on the CPU.

The 13 models of `ctr.py` (LR, FM, DNN, WideDeep, DeepFM, NFM, AFM, DCN,
DCNv2 in its three structures and with the low-rank mixture, xDeepFM with
both CIN activations, AutoInt with and without its tower, PNN, FiBiNET with
each bilinear type) get the flax model's params (`interop`) and the same
numpy batch: 3 categorical fields (one with a padding id) and a numeric
one, dim 4. Compared: the logits, the gradients of the BCE loss, and one
step of each package's dense `Trainer` (Adam 1e-2, clip 10). The
BatchNorm models (DNN, DeepFM on both paths) train 3 steps and are held to
JAX's ``batch_stats`` and eval-mode logits. `PackedEmbeddingTrainer` over
DCNv2 (one 4-wide value slot a pack row) and xDeepFM (4 + 1) runs 3 steps
against JAX's packed trainer (its Pallas delta kernel in interpret mode):
packs, dense weights, losses.

Tolerances: f32 logits rtol 1e-5 (atol 1e-6), gradients rtol 1e-4 (atol
1e-6), one Adam step rtol 1e-4 (atol 1e-5, a thousandth of the step's
size lr = 1e-2: Adam divides each element by its own RMS, so a
1e-7-relative gradient difference of a near-zero element becomes an
absolute one of up to ~2e-6); BatchNorm statistics and eval logits
after 3 steps rtol 1e-4 (atol 1e-5); the packed trainers' losses rtol
1e-5 and packs / weights rtol 1e-4 + atol 1e-5 (AdaGrad and Adam steps,
as above). bf16 compute: logits within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.ranking import ctr as J
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.packed import PackedEmbeddingTrainer as JPacked
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params, load_packed_state
from recbox_tpu_torch.models.ranking import ctr as P
from recbox_tpu_torch.nn.core import BatchNorm
from recbox_tpu_torch.ops.losses import binary_crossentropy
from recbox_tpu_torch.training import (
    PackedEmbeddingTrainer, Trainer, TrainerConfig,
)

DIM, B = 4, 64
VOCABS = {"c0": 11, "c1": 7, "c2": 13}
H = (8,)

ZOO = [
    ("LR", {}),
    ("FM", {}),
    ("DNN", dict(hidden_units=H)),
    ("WideDeep", dict(hidden_units=H)),
    ("DeepFM", dict(hidden_units=(8, 6))),
    ("DeepFM", dict(hidden_units=(8, 6), feature_major_compute=True)),
    ("NFM", dict(hidden_units=H)),
    ("AFM", dict(attention_dim=3)),
    ("DCN", dict(num_cross_layers=2, hidden_units=H)),
    ("DCNv2", dict(num_cross_layers=2, hidden_units=H)),
    ("DCNv2", dict(num_cross_layers=2, hidden_units=H,
                   model_structure="stacked")),
    ("DCNv2", dict(num_cross_layers=2, model_structure="crossnet_only")),
    ("DCNv2", dict(num_cross_layers=2, hidden_units=H,
                   use_low_rank_mixture=True, low_rank=3, num_experts=2)),
    ("xDeepFM", dict(cin_layer_sizes=(3, 2), hidden_units=H)),
    ("xDeepFM", dict(cin_layer_sizes=(3, 2), hidden_units=H,
                     cin_activation="relu")),
    ("AutoInt", dict(num_attention_layers=2, attention_dim=3)),
    ("AutoInt", dict(num_attention_layers=1, attention_dim=3,
                     hidden_units=H)),
    ("PNN", dict(hidden_units=H)),
    ("FiBiNET", dict(hidden_units=H, reduction_ratio=2)),
    ("FiBiNET", dict(hidden_units=H, bilinear_type="field_all")),
    ("FiBiNET", dict(hidden_units=H, bilinear_type="field_each")),
]
IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}"
       for n, kw in ZOO]


def _specs(S):
    return (S("c0", "categorical", vocab_size=VOCABS["c0"],
              embedding_dim=DIM, padding_idx=0),
            S("c1", "categorical", vocab_size=VOCABS["c1"],
              embedding_dim=DIM),
            S("c2", "categorical", vocab_size=VOCABS["c2"],
              embedding_dim=DIM),
            S("n0", "numeric", embedding_dim=DIM))


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


def _models(name, kw, compute_dtype="float32"):
    jfm = JFeatureMap("t", _specs(JFeatureSpec), labels=("click",))
    pfm = FeatureMap("t", _specs(FeatureSpec), labels=("click",))
    kw = dict(kw, embedding_dim=DIM, compute_dtype=compute_dtype)
    return (getattr(J, name)(feature_map=jfm, **kw),
            getattr(P, name)(pfm, device="cpu", **kw))


def _transplant(jm, pm, batch):
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), batch))
    pm.load_state_dict(from_jax_params(variables, pm))
    return variables


@pytest.mark.parametrize("name,kw", ZOO, ids=IDS)
def test_zoo_forward_grads_and_one_step_match_jax(name, kw):
    jm, pm = _models(name, kw)
    batch = _batch(0)
    variables = _transplant(jm, pm, batch)
    params = variables["params"]

    def jloss(p):
        out = jm.apply({"params": p}, batch)
        return jbce(out, batch["click"]), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
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
    # one step of each package's Trainer from the same weights
    pm.zero_grad()
    cfg = dict(learning_rate=1e-2, monitor="AUC")
    jt = JTrainer(jm, lambda o, b: jbce(o, b["click"]),
                  JTrainerConfig(**cfg))
    jt.init(batch)
    jt.params = jax.tree_util.tree_map(jnp.asarray, params)
    jt.opt_state = jt.tx.init(jt.params)
    pt = Trainer(pm, lambda o, b: binary_crossentropy(o, b["click"]),
                 TrainerConfig(**cfg), device="cpu")
    step = _batch(1)
    np.testing.assert_allclose(float(pt.train_step(step)),
                               float(jt.train_step(step)), rtol=1e-5)
    expect = from_jax_params(_np_tree(jt.params), pm)
    for k, v in pm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name,kw", [
    ("DCNv2", dict(num_cross_layers=2, hidden_units=H)),
    ("xDeepFM", dict(cin_layer_sizes=(3, 2), hidden_units=H)),
    ("FiBiNET", dict(hidden_units=H)),
    ("AutoInt", dict(num_attention_layers=2, attention_dim=3)),
    ("DeepFM", dict(hidden_units=(8, 6), feature_major_compute=True,
                    batch_norm=True)),
], ids=["DCNv2", "xDeepFM", "FiBiNET", "AutoInt", "DeepFM-bn"])
def test_zoo_bf16_compute_close_to_jax(name, kw):
    """bf16 compute: bf16 embeddings and MLPs, the flax ``Dense``s without
    ``dtype=`` in f32; the logits come back f32 within 2e-2."""
    jm, pm = _models(name, kw, "bfloat16")
    batch = _batch(2)
    variables = _transplant(jm, pm, batch)
    jout = jm.apply(variables, batch)
    pm.eval()
    out = pm(_tb(batch))
    assert jout.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name,kw", [
    ("DNN", dict(hidden_units=(8, 6), batch_norm=True)),
    ("DeepFM", dict(hidden_units=(8, 6), batch_norm=True)),
    ("DeepFM", dict(hidden_units=(8, 6), batch_norm=True,
                    feature_major_compute=True)),
], ids=["DNN", "DeepFM-stacked", "DeepFM-feature-major"])
def test_batch_norm_statistics_follow_jax(name, kw):
    """flax's BatchNorm: ra = 0.99 ra + 0.01 batch, the batch's biased
    variance; three trainer steps move the running statistics as JAX's
    ``batch_stats``, and the eval-mode logits (normalized by them) agree.
    The steps are SGD's: the bias of a Dense under a BatchNorm has a true
    gradient of 0 (the norm removes it), and Adam would scale each
    package's rounding noise there up to a step of ~lr, moving the two
    biases, and so the running means, apart."""
    jm, pm = _models(name, kw)
    batch = _batch(3)
    cfg = dict(optimizer="sgd", learning_rate=0.5, monitor="AUC")
    jt = JTrainer(jm, lambda o, b: jbce(o, b["click"]),
                  JTrainerConfig(**cfg))
    jt.init(batch)
    assert "batch_stats" in jt.model_state
    pm.load_state_dict(from_jax_params(
        {"params": _np_tree(jt.params), **_np_tree(jt.model_state)}, pm))
    pt = Trainer(pm, lambda o, b: binary_crossentropy(o, b["click"]),
                 TrainerConfig(**cfg), device="cpu")
    pt.init(batch)
    norms = [m for m in pm.modules() if isinstance(m, BatchNorm)]
    assert norms and set(pt.model_state) == {
        n for n, _ in pm.named_buffers()}
    for step in range(3):
        b = _batch(10 + step)
        np.testing.assert_allclose(float(pt.train_step(b)),
                                   float(jt.train_step(b)), rtol=1e-5)
    expect = from_jax_params({"params": _np_tree(jt.params),
                              **_np_tree(jt.model_state)}, pm)
    for k, v in pt.model_state.items():
        assert not torch.equal(v, torch.zeros_like(v)), k
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    test = _batch(20)
    jpred = np.asarray(jt.apply(test))
    np.testing.assert_allclose(pt.apply(test).numpy(), jpred, rtol=1e-4,
                               atol=1e-5)
    # the statistics ride the best-weight cache and the state dict
    pt._capture_best()
    saved = {k: v.clone() for k, v in pt.model_state.items()}
    pt.train_step(_batch(21))
    assert not all(torch.equal(saved[k], v)
                   for k, v in pt.model_state.items())
    pt._restore_best()
    for k, v in pt.model_state.items():
        assert torch.equal(v, saved[k]), k
    assert set(pt.state_dict()["model_state"]) == set(saved)


def test_batch_norm_module_is_flax_not_torch():
    """The running variance is the biased one and the new batch weighs
    0.01 (torch's BatchNorm1d would weigh it 0.1, unbiased)."""
    x = torch.randn(16, 3, generator=torch.Generator().manual_seed(0))
    bn = BatchNorm(3, device="cpu")
    y = bn(x)
    mean, var = x.mean(0), x.var(0, unbiased=False)
    torch.testing.assert_close(bn.mean, 0.01 * mean)
    torch.testing.assert_close(bn.var, 0.99 + 0.01 * var)
    torch.testing.assert_close(y, (x - mean) / torch.sqrt(var + 1e-5))
    bn.eval()
    torch.testing.assert_close(bn(x), (x - bn.mean)
                               / torch.sqrt(bn.var + 1e-5))


def test_models_without_first_order_have_no_linear_module():
    """DNN, DCN, DCNv2, AutoInt and PNN have no ``linear`` module in JAX,
    so the packed trainer plans one pack of embedding rows for them."""
    for name, kw in ZOO:
        _, pm = _models(name, kw)
        has = hasattr(pm, "linear")
        assert has == (name not in ("DNN", "DCN", "DCNv2", "AutoInt",
                                    "PNN")), name
        if name == "LR":
            assert not hasattr(pm, "embedding")


@pytest.mark.parametrize("name,kw,pack", [
    ("DCNv2", dict(num_cross_layers=2, hidden_units=H),
     "pack_embeddingx4"),
    ("xDeepFM", dict(cin_layer_sizes=(3, 2), hidden_units=H),
     "pack_embeddingx4_linearx1"),
], ids=["DCNv2", "xDeepFM"])
def test_packed_trainer_zoo_three_steps_match_jax(name, kw, pack):
    jm, pm = _models(name, kw)
    cfg = dict(learning_rate=1e-2, monitor="AUC")
    jt = JPacked(jm, lambda o, b: jbce(o, b["click"]), JTrainerConfig(**cfg),
                 delta_kernel="pallas")
    pt = PackedEmbeddingTrainer(
        pm, lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(**cfg), device="cpu")
    batch = _batch(30)
    jt.init(batch)
    pt.init(batch)
    assert list(pt.packs) == list(jt.packs) == [pack]
    assert tuple(pt.packs[pack].shape) == (sum(VOCABS.values()), 128)
    slots = pt._slots[pack]
    assert [s.dim for s in slots] == ([DIM] if name == "DCNv2"
                                      else [DIM, 1])
    load_packed_state(pt, _np_tree(jt.params),
                      {k: np.array(v) for k, v in jt.packs.items()})
    for step in range(3):
        b = _batch(40 + step)
        np.testing.assert_allclose(float(pt.train_step(b)),
                                   float(jt.train_step(b)), rtol=1e-5)
    np.testing.assert_allclose(pt.packs[pack].numpy(),
                               np.asarray(jt.packs[pack]), rtol=1e-4,
                               atol=1e-5)
    expect = from_jax_params(_np_tree(jt.params), pt.model)
    for k, v in pt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("use_bias", [True, False])
def test_logistic_regression_over_a_flat_input_matches_jax(use_bias):
    """`LogisticRegression` over a flat (B, K) input: a bias-free Dense (K
    → 1, ``Dense_0``) plus the global bias where ``use_bias``."""
    from recbox_tpu.nn.core import LogisticRegression as JLR
    from recbox_tpu_torch.nn.core import LogisticRegression
    x = np.random.default_rng(6).normal(size=(9, 5)).astype(np.float32)
    jm = JLR(use_bias=use_bias)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), x))["params"]
    params = jax.tree_util.tree_map(lambda a: a + 0.5, params)  # bias != 0
    pm = LogisticRegression(in_dim=5, use_bias=use_bias, device="cpu")
    pm.load_state_dict(from_jax_params(params, pm))
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply({"params": params}, x)),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="in_dim"):
        LogisticRegression(device="cpu")(torch.from_numpy(x))


@pytest.mark.parametrize("trainer", ["dense", "packed"])
def test_run_ranking_experiment_paired_with_jax(monkeypatch, trainer):
    """`run_ranking_experiment` over DCNv2 (2 epochs, Adam 1e-2; with
    ``trainer: packed`` AdaGrad on the packs through B1's plain version
    against JAX's Pallas kernel in interpret mode), the port's model
    starting from the JAX run's initial params (recorded after JAX's
    trainer init; the packed one packs them as JAX's exact init does):
    the valid and test metrics agree within 1e-5."""
    import recbox_tpu.training.packed as jpacked_mod
    import recbox_tpu.training.trainer as jtrainer_mod
    from recbox_tpu.quick_start import run_ranking_experiment as jrun
    from recbox_tpu_torch import quick_start as qs
    from tests.test_torch_reranking import load_inits

    inits = []
    for cls in (jtrainer_mod.Trainer, jpacked_mod.PackedEmbeddingTrainer):
        orig = cls.__dict__["init"]

        def init(self, sample_batch, _orig=orig):
            _orig(self, sample_batch)
            if not inits:
                inits.append(_np_tree(self.full_params()))

        monkeypatch.setattr(cls, "init", init)
    cfg = {"model": "DCNv2", "embedding_dim": DIM, "num_cross_layers": 2,
           "hidden_units": [8], "batch_size": 64, "epochs": 2,
           "learning_rate": 1e-2, "monitor": "AUC", "trainer": trainer,
           "lr_decay_factor": 1.0}
    train, valid, test = _batch(50, 512), _batch(51, 128), _batch(52, 128)
    jfm = JFeatureMap("t", _specs(JFeatureSpec), labels=("click",))
    pfm = FeatureMap("t", _specs(FeatureSpec), labels=("click",))
    if trainer == "packed":     # JAX's 'auto' is its jnp chain, B1's function
        monkeypatch.setattr(jpacked_mod.PackedEmbeddingTrainer,
                            "_use_delta_kernel", property(lambda s: True))
    want = jrun(cfg, jfm, train, valid, test)
    assert len(inits) == 1
    load_inits(monkeypatch, inits)
    got = qs.run_ranking_experiment(cfg, pfm, train, valid, test,
                                    device="cpu")
    assert list(got) == list(want) and "test_AUC" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
