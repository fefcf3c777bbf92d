"""The port's multitask models against the JAX package's, on the CPU.

SharedBottom, MMOE, PLE (one level and two), ESMM and AITM over a
schema of 3 categorical fields and a numeric one, dim 4, with two labels
(click, and conversion only where click is 1, the CTCVR structure ESMM
assumes): JAX's params carried over (`interop`), the (B, 2) outputs, the
gradients of `multitask_loss` and one step of the port's dense `Trainer`
against JAX's trainer optimizer (`_make_optimizer`: Adam 1e-2, clip 10)
on JAX's gradients of the same batch. Then `multitask_loss` itself (logits and
probabilities, weighted), the multitask branch of `run_ranking_experiment`
paired with JAX's (the port's model starting from the JAX run's initial
params; dense for MMOE and ESMM, packed for MMOE), and
`metabalance_combine` against JAX's over three steps.

Tolerances: outputs rtol 1e-5 (atol 1e-6); losses rtol 1e-5; gradients
rtol 1e-4 (atol 1e-6); the Adam step by `check_adam_state` (SASRec's
rule, `tests/test_torch_sequence_ctr.py`); the paired experiments'
metrics within 1e-4; MetaBalance's combined gradients and norms rtol
1e-5 (atol 1e-7).
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
from recbox_tpu.models.multitask import models as J
from recbox_tpu.training import metabalance as jmb
from recbox_tpu.training.trainer import TrainerConfig as JTrainerConfig
from recbox_tpu.training.trainer import _make_optimizer as j_make
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models import multitask as P
from recbox_tpu_torch.training import Trainer, TrainerConfig
from recbox_tpu_torch.training import metabalance as pmb
from test_torch_sequence_ctr import check_adam_state

DIM, B = 4, 64
VOCABS = {"c0": 11, "c1": 7, "c2": 13}
LABELS = ("click", "conv")

ZOO = [
    ("SharedBottom", dict(bottom_units=(8, 6), tower_units=(5,))),
    ("MMOE", dict(num_experts=3, expert_units=(8, 6), tower_units=(5,))),
    ("PLE", dict(num_levels=1, specific_experts=2, shared_experts=1,
                 expert_units=(6,), tower_units=(5,))),
    ("PLE", dict(num_levels=2, specific_experts=1, shared_experts=2,
                 expert_units=(8, 6), tower_units=(5,))),
    ("ESMM", dict(tower_units=(8, 5))),
    ("AITM", dict(tower_units=(8,), transfer_dim=6)),
]
IDS = ["SharedBottom", "MMOE", "PLE-1", "PLE-2", "ESMM", "AITM"]


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
    click = (batch["c1"] % 2 == 0) ^ (rng.random(b) < 0.2)
    batch["click"] = click.astype(np.float32)
    batch["conv"] = (click & (batch["c2"] < 6)).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _fms():
    return (JFeatureMap("m", _specs(JFeatureSpec), labels=LABELS),
            FeatureMap("m", _specs(FeatureSpec), labels=LABELS))


def _models(name, kw):
    jfm, pfm = _fms()
    kw = dict(kw, embedding_dim=DIM)
    return (getattr(J, name)(feature_map=jfm, **kw),
            getattr(P, name)(pfm, device="cpu", **kw))


def _jloss(name):
    logits = name != "ESMM"
    return lambda o, b: J.multitask_loss(
        o, jnp.stack([b[k] for k in LABELS], axis=1), from_logits=logits)


def _ploss(name):
    logits = name != "ESMM"
    return lambda o, b: P.multitask_loss(
        o, torch.stack([b[k] for k in LABELS], dim=1), from_logits=logits)


@pytest.mark.parametrize("name,kw", ZOO, ids=IDS)
def test_multitask_forward_grads_and_one_step_match_jax(name, kw):
    jm, pm = _models(name, kw)
    batch = _batch(0)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), batch))["params"]
    pm.load_state_dict(from_jax_params(params, pm))
    jl_fn = _jloss(name)
    step = _batch(1)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: (lambda o: (jl_fn(o, b), o))(
            jm.apply({"params": p}, b)), has_aux=True))
    (jl, jout), jg = vg(params, batch)
    (jl_step, _), step_grads = vg(params, step)
    tx = j_make(JTrainerConfig(learning_rate=1e-2))
    updates, _ = tx.update(step_grads, tx.init(params), params)
    stepped = optax.apply_updates(params, updates)
    tb = _tb(batch)
    out = pm(tb)
    assert out.shape == (B, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    if name == "ESMM":      # pCTCVR = pCTR · pCVR <= pCTR
        assert pm.output_type == "probs"
        assert bool((out[:, 1] <= out[:, 0]).all())
    loss = _ploss(name)(out, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    expect = from_jax_params(_np_tree(jg), pm)
    named = dict(pm.named_parameters())
    assert set(expect) == set(named)
    for k, g in expect.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    pm.zero_grad()
    pt = Trainer(pm, _ploss(name), TrainerConfig(learning_rate=1e-2,
                                                 monitor="AUC"),
                 device="cpu")
    np.testing.assert_allclose(float(pt.train_step(step)), float(jl_step),
                               rtol=1e-5)
    check_adam_state(pm, _np_tree(stepped), 1e-2,
                     from_jax_params(_np_tree(step_grads), pm))


def test_batched_experts_draw_at_flax_fans():
    """The (E, in, out) kernels are drawn at flax's fans, which count the
    E experts as a receptive field: std sqrt(2 / (E·(in + out))), not a
    per-expert xavier's sqrt(2 / (in + out))."""
    _, pfm = _fms()
    m = P.MMOE(pfm, embedding_dim=DIM, num_experts=8,
               expert_units=(256,), generator=torch.Generator()
               .manual_seed(0), device="cpu")
    w = m.experts.w0
    e, fin, fout = w.shape
    want = np.sqrt(2.0 / (e * (fin + fout)))
    assert abs(float(w.std()) / want - 1.0) < 0.05


@pytest.mark.parametrize("from_logits", [True, False])
@pytest.mark.parametrize("weights", [None, (0.3, 2.0)])
def test_multitask_loss_matches_jax(from_logits, weights):
    rng = np.random.default_rng(3)
    out = rng.normal(size=(40, 2)).astype(np.float32) * 4
    if not from_logits:
        out = 1.0 / (1.0 + np.exp(-out))
        out[0, 0], out[1, 1] = 0.0, 1.0          # the clip's edges
    y = (rng.random((40, 2)) < 0.4).astype(np.float32)
    want = J.multitask_loss(jnp.asarray(out), jnp.asarray(y), weights,
                            from_logits)
    got = P.multitask_loss(torch.from_numpy(out), torch.from_numpy(y),
                           weights, from_logits)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _arrays(seed, n):
    return _batch(seed, n)


@pytest.mark.parametrize("name,trainer", [("MMOE", "dense"),
                                          ("ESMM", "dense"),
                                          ("MMOE", "packed")])
def test_run_ranking_experiment_multitask_paired_with_jax(monkeypatch, name,
                                                          trainer):
    """The multitask branch: `multitask_loss` over both labels (ESMM's
    probabilities with from_logits=False), `MultiTaskEvaluator` on valid
    and test, 2 epochs of Adam 1e-2 (AdaGrad on the packs through B1's
    plain version against JAX's Pallas kernel in interpret mode); the
    port's model starts from the JAX run's initial params. Every metric
    within 1e-4."""
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
    kw = dict(ZOO[IDS.index(name)][1])
    cfg = {"model": name, "embedding_dim": DIM, **kw, "batch_size": 64,
           "epochs": 2, "learning_rate": 1e-2, "monitor": "AUC",
           "trainer": trainer, "lr_decay_factor": 1.0}
    if name == "ESMM":
        cfg["output_type"] = "probs"
    train, valid, test = _arrays(50, 512), _arrays(51, 128), _arrays(52, 128)
    jfm, pfm = _fms()
    if trainer == "packed":
        monkeypatch.setattr(jpacked_mod.PackedEmbeddingTrainer,
                            "_use_delta_kernel", property(lambda s: True))
    want = jrun(cfg, jfm, train, valid, test)
    assert len(inits) == 1
    load_inits(monkeypatch, inits)
    got = qs.run_ranking_experiment(cfg, pfm, train, valid, test,
                                    device="cpu")
    assert list(got) == list(want)
    assert {"click_AUC", "conv_AUC", "test_conv_logloss"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_run_experiment_still_refuses_multitask():
    """`run_experiment` keeps raising for a multitask model, as JAX's:
    one .inter file cannot carry two labels."""
    from recbox_tpu_torch.quick_start import run_experiment
    with pytest.raises(NotImplementedError, match="multitask"):
        run_experiment("MMOE", "ml-100k", device="cpu")


def test_metabalance_combine_matches_jax():
    """Three steps of per-task gradients of shared parameters: the
    combined gradients and the moving-average norms follow JAX's; a task
    tree may be a dict or a list."""
    rng = np.random.default_rng(4)
    shapes = {"w": (5, 3), "b": (3,)}
    jstate = jmb.metabalance_init(3, {k: jnp.zeros(s)
                                      for k, s in shapes.items()})
    pstate = pmb.metabalance_init(3, {k: torch.zeros(s)
                                      for k, s in shapes.items()})
    lstate = pmb.metabalance_init(3, [torch.zeros(s)
                                      for s in shapes.values()])
    for _ in range(3):
        grads = [{k: (rng.normal(size=s) * (t + 1) * 0.5).astype(np.float32)
                  for k, s in shapes.items()} for t in range(3)]
        jc, jstate = jmb.metabalance_combine(
            [{k: jnp.asarray(v) for k, v in g.items()} for g in grads],
            jstate, relax_factor=0.6, beta=0.8)
        pc, pstate = pmb.metabalance_combine(
            [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads],
            pstate, relax_factor=0.6, beta=0.8)
        lc, lstate = pmb.metabalance_combine(
            [[torch.from_numpy(g[k]) for k in shapes] for g in grads],
            lstate, relax_factor=0.6, beta=0.8)
        for i, k in enumerate(shapes):
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(lc[i].numpy(), np.asarray(jc[k]),
                                       rtol=1e-5, atol=1e-7)
            for t in range(3):
                np.testing.assert_allclose(
                    float(pstate.norms[t][k]),
                    float(jstate.norms[t][k]), rtol=1e-5)
