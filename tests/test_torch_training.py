"""Port DeepFM packed training against the JAX package, on the CPU.

Same numpy inputs through both packages (4 categorical and 2 numeric
fields, vocab 64, dim 8, MLP (16,)), the JAX params and packs transplanted
onto the port through `interop`. Kernel B1 runs its plain version here (its
CUDA kernel is held against that version on the card by `chip_smoke.py`);
the JAX kernel `fused_adagrad_delta` runs in Pallas interpret mode.

Tolerances: f32 forward, gradients and three trainer steps agree to rtol
1e-5 (the two sides sum in different orders). After three steps the packs
and the dense params also get atol 1e-6: AdaGrad divides each row's
gradient by the row's RMS and Adam each element's by its own, so the
gradients' 1e-7-level relative differences become absolute ones of up to
~3e-7 where a row or an element is small (seen on 6 of 32,768 pack
entries and 13 of 768 weights). B1's plain version agrees with the JAX
kernel to rtol 1e-6 (the same elementwise op order, only the mean's sum
may reorder). bf16 compute rounds at other places in the two
frameworks, so there the loss agrees within 1e-2 relative and the pack
within 2e-3 absolute, 4% of one AdaGrad step of size ~lr = 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from recbox_tpu.evaluation.ctr import auc_score as jauc
from recbox_tpu.evaluation.ctr import log_loss as jlog_loss
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.ops.pallas.packed_delta import fused_adagrad_delta
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.packed import PackedEmbeddingTrainer as JPacked
from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.evaluation import auc_score, log_loss
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import (
    _candidates, _flatten, from_jax_params, load_packed_state,
)
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.nn.embedding import rows_key_for
from recbox_tpu_torch.ops import packed_delta as pd_mod
from recbox_tpu_torch.ops.losses import binary_crossentropy, embedding_reg_loss
from recbox_tpu_torch.ops.packed_delta import (
    fused_adagrad_delta_plain, packed_adagrad_update_,
)
from recbox_tpu_torch.training import (
    PackedEmbeddingTrainer, Trainer, TrainerConfig,
)
from recbox_tpu_torch.training.trainer import is_embedding_table

N_CAT, N_NUM, VOCAB, DIM, HIDDEN, B = 4, 2, 64, 8, (16,), 256


def _specs(S):
    return tuple(
        S(f"c{i}", "categorical", vocab_size=VOCAB, embedding_dim=DIM)
        for i in range(N_CAT)) + tuple(
        S(f"n{i}", "numeric", embedding_dim=DIM) for i in range(N_NUM))


def _maps():
    return (JFeatureMap("t", _specs(JFeatureSpec), labels=("click",)),
            FeatureMap("t", _specs(FeatureSpec), labels=("click",)))


def _batch(seed, b=B):
    """Uniform ids (duplicates within a batch of 256 over 64 rows) and a
    label the model can learn (a parity rule over two fields)."""
    rng = np.random.default_rng(seed)
    batch = {f"c{i}": rng.integers(0, VOCAB, b).astype(np.int32)
             for i in range(N_CAT)}
    batch.update({f"n{i}": rng.normal(size=b).astype(np.float32)
                  for i in range(N_NUM)})
    batch["click"] = ((batch["c0"] % 2) == (batch["c1"] % 2)).astype(
        np.float32)
    return batch


def _models(feature_major, compute_dtype="float32"):
    jfm, pfm = _maps()
    kw = dict(embedding_dim=DIM, hidden_units=HIDDEN,
              feature_major_compute=feature_major,
              compute_dtype=compute_dtype)
    return JDeepFM(feature_map=jfm, **kw), DeepFM(pfm, device="cpu", **kw)


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _transplant(jm, pm, batch):
    params = _np_tree(jm.init(jax.random.PRNGKey(0), batch)["params"])
    pm.load_state_dict(from_jax_params(params, pm))
    return params


# -- 1. the model ---------------------------------------------------------------

@pytest.mark.parametrize("feature_major", [True, False])
def test_deepfm_forward_and_grads_match_jax(feature_major):
    jm, pm = _models(feature_major)
    batch = _batch(0)
    params = _transplant(jm, pm, batch)

    def jloss(p):
        out = jm.apply({"params": p}, batch)
        return jbce(out, batch["click"]), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tb = _tb(batch)
    out = pm(tb)
    loss = binary_crossentropy(out, tb["click"])
    loss.backward()
    assert out.shape == (B,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    expect = from_jax_params(_np_tree(jg), pm)
    named = dict(pm.named_parameters())
    assert set(expect) == set(named)
    for k, g in expect.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("feature_major", [True, False])
def test_deepfm_row_grads_match_jax(feature_major):
    """Pre-gathered rows through the `__rows__` protocol: same logits and
    the same (B, D) row gradients as the JAX model."""
    jm, pm = _models(feature_major)
    batch = _batch(1)
    params = _transplant(jm, pm, batch)
    rng = np.random.default_rng(2)
    rows = {}
    for mod, d in (("embedding", DIM), ("linear", 1)):
        for i in range(N_CAT):
            rows[rows_key_for((mod,), f"c{i}")] = (
                0.3 * rng.normal(size=(B, d))).astype(np.float32)

    def jloss(r):
        return jbce(jm.apply({"params": params}, {**batch, **r}),
                    batch["click"])

    jl, jg = jax.value_and_grad(jloss)(rows)
    trows = {k: torch.tensor(v, requires_grad=True) for k, v in rows.items()}
    tb = _tb(batch)
    loss = binary_crossentropy(pm({**tb, **trows}), tb["click"])
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k, t in trows.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


# -- 2. kernel B1's plain version -----------------------------------------------

@pytest.mark.parametrize("grad_dtype", [np.float32, jnp.bfloat16])
def test_fused_adagrad_delta_plain_matches_jax(grad_dtype):
    rng = np.random.default_rng(3)
    n, dims, w = 96, (8, 1), 128
    G = rng.normal(size=(n, w)).astype(np.float32)
    G[:, 9:11] = np.abs(G[:, 9:11])             # accumulators are >= 0
    grads = [np.asarray(jnp.asarray(rng.normal(size=(n, d)), grad_dtype))
             for d in dims]
    kw = dict(dims=dims, acc_cols=(9, 10), used=11, eps=1e-8)
    jupd = np.asarray(fused_adagrad_delta(G, grads, 0.05, store_w=w,
                                          interpret=True, **kw))
    tgrads = [torch.from_numpy(np.asarray(g, np.float32)).to(
        torch.bfloat16 if grad_dtype is jnp.bfloat16 else torch.float32)
        for g in grads]
    upd = fused_adagrad_delta_plain(torch.from_numpy(G), tgrads, 0.05,
                                    store_w=w, **kw)
    np.testing.assert_allclose(upd.numpy(), jupd, rtol=1e-6, atol=1e-12)
    # ... and applied at ids with duplicates, as `pack.at[ids].add`
    pack = rng.normal(size=(40, w)).astype(np.float32)
    ids = rng.integers(0, 40, n).astype(np.int32)
    assert len(np.unique(ids)) < n
    jpack = np.asarray(jnp.asarray(pack).at[ids].add(jupd))
    tpack = torch.from_numpy(pack.copy())
    out = packed_adagrad_update_(tpack, torch.from_numpy(ids),
                                 torch.from_numpy(G), tgrads, 0.05, **kw)
    assert out is tpack
    np.testing.assert_allclose(tpack.numpy(), jpack, rtol=1e-6, atol=1e-7)


def test_packed_update_cuda_tensor_never_takes_plain_version(monkeypatch):
    """Only a CPU pack reaches the plain version: any other device goes to
    the kernel path, which raises rather than fall back."""
    def refuse(*a, **k):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(pd_mod, "packed_adagrad_update_plain_", refuse)
    before = dict(pd_mod.launches)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        packed_adagrad_update_(
            torch.empty((40, 128), **meta),
            torch.empty(8, dtype=torch.int32, **meta),
            torch.empty((8, 128), **meta),
            [torch.empty((8, 8), **meta), torch.empty((8, 1), **meta)],
            0.05, dims=(8, 1), acc_cols=(9, 10), used=11, eps=1e-8)
    assert pd_mod.launches == before
    with pytest.raises(ValueError, match="used=12"):
        packed_adagrad_update_(
            torch.zeros((40, 128)), torch.zeros(8, dtype=torch.int32),
            torch.zeros((8, 128)), [torch.zeros((8, 8)), torch.zeros((8, 1))],
            0.05, dims=(8, 1), acc_cols=(9, 10), used=12, eps=1e-8)


_BASE = 0x7F0000000000      # a 16-byte aligned device address


@pytest.mark.parametrize("pack_w,ptr,vec", [
    (128, _BASE, 4),          # DeepFM's pack: 17 reductions of 4 a row
    (130, _BASE, 2),          # rows of 130 floats
    (67, _BASE, 1),           # odd rows: scalar reductions
    (128, _BASE + 8, 2),      # base 8-byte aligned only
    (128, _BASE + 4, 1),      # base 4-byte aligned only
    (130, _BASE + 8, 2),
    (130, _BASE + 4, 1),
    (132, _BASE, 4),
    (16, _BASE, 4),
    (30000, _BASE + 24, 2),
])
def test_reduction_width(pack_w, ptr, vec):
    """B1's reduction width: the widest of 4, 2, 1 floats that divides the
    pack's row width and its base address."""
    assert pd_mod.reduction_width(pack_w, ptr) == vec


# -- 3. the packed trainer -------------------------------------------------------

def _trainers(feature_major, compute_dtype="float32", **jkw):
    jm, pm = _models(feature_major, compute_dtype)
    cfg = dict(learning_rate=1e-2, monitor="AUC")
    jt = JPacked(jm, lambda o, b: jbce(o, b["click"]), JTrainerConfig(**cfg),
                 **jkw)
    pt = PackedEmbeddingTrainer(
        pm, lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(**cfg), device="cpu")
    batch = _batch(10)
    jt.init(batch)
    pt.init(batch)
    load_packed_state(pt, _np_tree(jt.params),
                      {k: np.array(v) for k, v in jt.packs.items()})
    return jt, pt


@pytest.mark.parametrize("feature_major", [True, False])
def test_packed_trainer_three_steps_match_jax(feature_major):
    """Three steps of the port's trainer (B1's plain version) against the
    JAX trainer running its Pallas delta kernel: losses, packs and dense
    params agree in f32."""
    jt, pt = _trainers(feature_major, delta_kernel="pallas")
    for step in range(3):
        batch = _batch(20 + step)
        jl = float(jt.train_step(batch))
        pl_ = float(pt.train_step(batch))
        np.testing.assert_allclose(pl_, jl, rtol=1e-5)
    assert pt.step == 3
    (name, jpack), = jt.packs.items()
    np.testing.assert_allclose(pt.packs[name].numpy(), np.asarray(jpack),
                               rtol=1e-5, atol=1e-6)
    expect = from_jax_params(_np_tree(jt.params), pt.model)
    for k, v in pt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # predictions read the tables from the packs, as JAX's full_params
    jpred = np.asarray(jt.apply(_batch(30)))
    batch = _batch(30)
    batch.pop("click")
    ppred = pt.predict([batch])
    # the params' 1e-6 differences add up over the forward's sums
    np.testing.assert_allclose(ppred, jpred, rtol=1e-5, atol=1e-5)


def test_packed_trainer_bf16_compute_close_to_jax():
    """bf16 compute (the Criteo bench regime): the rows reach the model and
    the row gradients come back in bf16; the loss agrees within 1e-2
    relative, the pack within 2e-3."""
    jt, pt = _trainers(True, "bfloat16", delta_kernel="pallas")
    assert pt._rows_dtype == torch.bfloat16
    for step in range(3):
        batch = _batch(40 + step)
        jl = float(jt.train_step(batch))
        pl_ = float(pt.train_step(batch))
        assert abs(pl_ - jl) <= 1e-2 * abs(jl), (pl_, jl)
    (name, jpack), = jt.packs.items()
    np.testing.assert_allclose(pt.packs[name].numpy(), np.asarray(jpack),
                               rtol=0, atol=2e-3)


def test_pack_layout_deepfm():
    """Both module widths plus the accumulators share one pack, laid out
    as the JAX trainer lays it out (`test_packed_training.py:34-59`)."""
    jt, pt = _trainers(True)
    assert list(pt.packs) == list(jt.packs)
    pname = next(iter(pt.packs))
    pack = pt.packs[pname]
    # 4 vocabs x 64 rows; used = 8 (embedding) + 1 (linear) + 2 acc = 11,
    # stored 128 wide
    assert tuple(pack.shape) == (256, 128) == tuple(jt.packs[pname].shape)
    assert pt._pack_store_width[pname] == 128
    assert pt._value_width[pname] + len(pt._slots[pname]) == 11
    assert float(pack[:, 11:].abs().max()) == 0.0
    keys = {f"{m}/emb_c{i}" for m in ("embedding", "linear")
            for i in range(N_CAT)}
    assert set(pt.tables) == keys == set(jt.tables)
    assert tuple(pt.tables["embedding/emb_c0"].shape) == (VOCAB, DIM)
    assert tuple(pt.tables["linear/emb_c0"].shape) == (VOCAB, 1)
    assert set(pt.accumulators) == keys
    # the model keeps only its dense parameters; full_params has them all
    assert not any(".tables." in k for k in pt.params)
    _, fresh = _models(True)
    fresh.load_state_dict(pt.full_params())


def test_packed_only_touched_rows_change():
    _, pt = _trainers(True)
    batch = _batch(50, b=3)
    batch["c0"] = np.array([3, 3, 5], np.int32)
    before = pt.tables["embedding/emb_c0"].clone()
    pt.train_step(batch)
    after = pt.tables["embedding/emb_c0"]
    changed = set(np.where((after - before).abs().sum(-1).numpy() > 0)[0])
    assert changed == {3, 5}
    acc = pt.accumulators["embedding/emb_c0"].numpy()
    assert (acc[[3, 5]] > 0).all()
    assert (np.delete(acc, [3, 5]) == 0).all()
    lin = pt.tables["linear/emb_c0"].numpy()
    assert np.abs(lin[[3, 5]]).sum() > 0


@pytest.mark.parametrize("feature_major", [True, False])
def test_direct_init_draws_the_pack(feature_major):
    jm, pm = _models(feature_major)
    pt = PackedEmbeddingTrainer(
        pm, lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(seed=7), direct_init=True, adagrad_init=0.1,
        device="cpu")
    pt.init(_batch(60))
    pack = next(iter(pt.packs.values()))
    std = float(pack[:, :DIM + 1].std())
    assert 0.5e-4 < std < 2e-4
    assert torch.all(pack[:, DIM + 1:DIM + 3] == 0.1)
    assert float(pack[:, DIM + 3:].abs().max()) == 0.0
    loss = pt.train_step(_batch(61))
    assert torch.isfinite(loss)


def test_delta_kernel_values_and_unported_paths():
    """delta_kernel takes the JAX package's three values and rejects any
    other; the embedding optimizers are JAX's two, 'adagrad' and 'adam'
    (lazy Adam), and any other raises NotImplementedError, as in JAX;
    block_rows is taken (`tests/test_torch_packed_layouts.py` trains it)."""
    _, pm = _models(True)

    def make(**kw):
        return PackedEmbeddingTrainer(
            pm, lambda o, b: binary_crossentropy(o, b["click"]),
            TrainerConfig(), device="cpu", **kw)

    for value in ("auto", "pallas", "xla"):
        assert make(delta_kernel=value).delta_kernel == value
    assert make(embedding_optimizer="adam").embedding_optimizer == "adam"
    assert make(block_rows=True).block_rows
    for kw in (dict(delta_kernel="cuda"), dict(embedding_optimizer="sgd")):
        with pytest.raises(NotImplementedError):
            make(**kw)
        with pytest.raises(NotImplementedError):
            JPacked(_models(True)[0], None, JTrainerConfig(), **kw)
    with pytest.raises(NotImplementedError, match="optimizer"):
        Trainer(pm, None, TrainerConfig(optimizer="lamb"),
                device="cpu").init({})


def test_dense_trainer_steps_and_lr():
    """The dense Trainer trains the tables with Adam too; the plateau hook
    scales the packed trainer's embedding lr with the dense lr. The lr is
    held as a float32 tensor, as optax's injected hyperparameter is, so it
    reads back rounded to float32 (JAX's `learning_rate` likewise)."""
    _, pm = _models(True)
    t = Trainer(pm, lambda o, b: binary_crossentropy(o, b["click"]),
                TrainerConfig(learning_rate=3e-2), device="cpu")
    batch = _batch(70)
    losses = t.train_steps_repeat(batch, 12)
    assert losses.shape == (12,) and float(losses[-1]) < float(losses[0])
    assert t.learning_rate == np.float32(3e-2)
    _, pt = _trainers(True)
    pt.train_step(_batch(71))
    assert pt._emb_lr == 5e-2
    pt._set_learning_rate(1e-3)
    assert pt.learning_rate == np.float32(1e-3)
    np.testing.assert_allclose(pt._emb_lr, 5e-3)


@pytest.mark.parametrize("feature_major", [True, False])
def test_regularizer_selection_matches_jax(feature_major):
    """The dense Trainer's regularizers take as embedding tables the
    parameters JAX takes (a flax path component starting ``emb_``): for
    DeepFM, every ``.tables.`` parameter and nothing else, as before."""
    jm, pm = _models(feature_major)
    params = _transplant(jm, pm, _batch(72))
    target = pm.state_dict()
    jax_tables = set()
    for path, arr in _flatten(params):
        if any(part.startswith("emb_") for part in path):
            jax_tables.add(next(k for k, _ in _candidates(path, arr)
                                if k in target))
    port = {n for n, _ in pm.named_parameters() if is_embedding_table(n)}
    assert port == jax_tables
    assert port == {n for n, _ in pm.named_parameters()
                    if ".tables." in "." + n}


# -- 4. metrics, losses, devices ---------------------------------------------------

def test_ctr_metrics_and_losses_match_jax():
    rng = np.random.default_rng(80)
    y = (rng.random(500) > 0.6).astype(np.float32)
    p = np.round(rng.random(500), 2)          # ties share their rank
    assert auc_score(y, p) == jauc(y, p)
    np.testing.assert_allclose(log_loss(y, p), jlog_loss(y, p), rtol=1e-12)
    logits = rng.normal(size=500).astype(np.float32)
    for from_logits in (True, False):
        x = logits if from_logits else 1 / (1 + np.exp(-logits))
        np.testing.assert_allclose(
            float(binary_crossentropy(torch.from_numpy(x), torch.from_numpy(y),
                                      from_logits)),
            float(jbce(x, y, from_logits)), rtol=1e-6)
    from recbox_tpu.ops import embedding_reg_loss as jreg
    w = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(embedding_reg_loss({"embedding/emb_a": torch.from_numpy(w),
                                  "dnn/kernel": torch.ones(2)})),
        float(jreg({"embedding": {"emb_a": w}, "dnn": {"kernel": np.ones(2)}})),
        rtol=1e-6)


def test_training_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pfm = _maps()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepFM(pfm, embedding_dim=DIM, hidden_units=HIDDEN)
    _, pm = _models(True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PackedEmbeddingTrainer(pm, None, TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embedding_reg_loss({})
    assert resolve_device("cpu") == torch.device("cpu")
    assert float(embedding_reg_loss({}, device="cpu")) == 0.0
