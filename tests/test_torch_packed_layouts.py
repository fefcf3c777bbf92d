"""The packed trainer's other layouts against the JAX package's, on the CPU:
block rows, the split-accumulator layout, lazy Adam, and the pretrained
and frozen tables.

The models are `test_torch_training.py`'s DeepFM (4 categorical fields of
64 ids, dim 8, 2 numeric fields) and a DCNv2 at ``embedding_dim`` 128, so
its one value slot fills the 128-lane pad and the accumulator goes to the
split ``accs`` (JAX `packed.py:205-243`). Each port trainer starts from the
JAX trainer's initial state (`interop.load_packed_state`, packs and
``accs``); batches of 256 ids over 64 rows repeat ids within a step.
Compared over three steps: losses, packs (values and optimizer state),
``accs``, ``accumulators`` and the dense parameters. Block rows run the
port's B1 plain version against JAX's jnp chain, and against the port's
own per-feature path; the split and lazy-Adam updates are plain torch in
the port (jnp chains in JAX).

Tolerances (`test_torch_training.py`'s): losses rtol 1e-5; packs, ``accs``
and dense parameters rtol 1e-5 / atol 1e-6 (AdaGrad and Adam divide by
small second moments, so relative differences of 1e-7 in the gradients
become absolute ones of a few 1e-7); DCNv2's dense weights atol 1e-5, as
`test_torch_ctr_zoo.py` holds them (its 384 x 384 cross kernel has
elements whose Adam steps divide by a near-zero RMS: up to ~5e-6 apart
after three steps); the block path against the per-feature one as the
first.
"""

import jax
import numpy as np
import pytest
import torch

import flax.linen as fnn
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.ranking.ctr import DCNv2 as JDCNv2
from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
from recbox_tpu.nn.embedding import FeatureEmbedding as JFeatureEmbedding
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.packed import PackedEmbeddingTrainer as JPacked
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params, load_packed_state
from recbox_tpu_torch.models.ranking import DCNv2, DeepFM
from recbox_tpu_torch.nn.embedding import FeatureEmbedding, rows_block_key
from recbox_tpu_torch.ops import packed_delta as pd_mod
from recbox_tpu_torch.ops.losses import binary_crossentropy
from recbox_tpu_torch.training import PackedEmbeddingTrainer, TrainerConfig
from recbox_tpu_torch.training import packed as packed_mod
from test_torch_training import B, DIM, HIDDEN, N_CAT, VOCAB, _batch, _np_tree

CFG = dict(learning_rate=1e-2, monitor="AUC")


def _specs(S, **extra):
    """4 categorical and 2 numeric fields; ``extra`` maps a field to extra
    spec arguments (padding_idx, freeze_emb, a sequence type)."""
    out = []
    for i in range(N_CAT):
        kw = dict(type="categorical", vocab_size=VOCAB, embedding_dim=DIM)
        kw.update(extra.get(f"c{i}", {}))
        out.append(S(f"c{i}", **kw))
    return tuple(out) + tuple(S(f"n{i}", "numeric", embedding_dim=DIM)
                              for i in range(2))


def _deepfm(feature_major=True, **extra):
    kw = dict(embedding_dim=DIM, hidden_units=HIDDEN,
              feature_major_compute=feature_major)
    return (JDeepFM(feature_map=JFeatureMap("t", _specs(JFeatureSpec,
                                                        **extra),
                                            labels=("click",)), **kw),
            DeepFM(FeatureMap("t", _specs(FeatureSpec, **extra),
                              labels=("click",)), device="cpu", **kw))


def _dcnv2(dim=128):
    kw = dict(embedding_dim=dim, num_cross_layers=1, hidden_units=(16,))
    jfm = JFeatureMap("t", tuple(JFeatureSpec(f"c{i}", "categorical",
                                              vocab_size=VOCAB,
                                              embedding_dim=dim)
                                 for i in range(3)), labels=("click",))
    pfm = FeatureMap("t", tuple(FeatureSpec(f"c{i}", "categorical",
                                            vocab_size=VOCAB,
                                            embedding_dim=dim)
                                for i in range(3)), labels=("click",))
    return JDCNv2(feature_map=jfm, **kw), DCNv2(pfm, device="cpu", **kw)


def _ctr_batch(seed, n_cat=N_CAT):
    """`_batch`'s click and first ``n_cat`` categorical fields."""
    batch = _batch(seed)
    return {k: batch[k] for k in ["click"] + [f"c{i}" for i in range(n_cat)]}


def _paired(models, batch, jkw=None, pkw=None):
    """A JAX and a port PackedEmbeddingTrainer over ``models``, the port's
    from the JAX one's initial dense params, packs and accs."""
    jm, pm = models
    jt = JPacked(jm, lambda o, b: jbce(o, b["click"]),
                 JTrainerConfig(**CFG), **(jkw or {}))
    pt = PackedEmbeddingTrainer(
        pm, lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(**CFG), device="cpu", **(pkw or {}))
    jt.init(batch)
    pt.init(batch)
    load_packed_state(pt, _np_tree(jt.params),
                      {k: np.array(v) for k, v in jt.packs.items()},
                      accs={k: np.array(v) for k, v in jt.accs.items()})
    return jt, pt


def _close(got, want, msg="", rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _steps_match(jt, pt, batches, dense_atol=1e-6):
    for batch in batches:
        _close(float(pt.train_step(batch)), float(jt.train_step(batch)),
               "loss", atol=0)
    for name in jt.packs:
        _close(pt.packs[name], jt.packs[name], name)
    assert set(pt.accs) == set(jt.accs)
    for name in jt.accs:
        _close(pt.accs[name], jt.accs[name], f"accs {name}")
    jacc = jt.accumulators
    assert set(pt.accumulators) == set(jacc)
    for k, v in pt.accumulators.items():
        _close(v, jacc[k], f"accumulators {k}")
    expect = from_jax_params(_np_tree(jt.params), pt.model)
    for k, v in pt.model.state_dict().items():
        _close(v, expect[k].numpy(), k, atol=dense_atol)


# -- block rows -----------------------------------------------------------------

@pytest.mark.parametrize("feature_major", [True, False])
def test_block_rows_deepfm_matches_jax_block_path(feature_major):
    """Block mode on both sides: one (F, B, D) entry a slot, the rows and
    gradients in schema order; three steps agree, B1's plain version
    against JAX's jnp chain."""
    jt, pt = _paired(_deepfm(feature_major), _batch(10),
                     dict(block_rows=True), dict(block_rows=True))
    (pname, on), = pt._block_mode.items()
    assert on and jt._block_mode == {pname: True}
    assert [f for f, _ in pt._gather_order[pname]] == \
        [f"c{i}" for i in range(N_CAT)]
    rows, ctx = pt._gather_rows(pt._device_batch(_batch(11)))
    assert set(rows) == {rows_block_key(("embedding",)),
                         rows_block_key(("linear",))}
    assert tuple(rows[rows_block_key(("embedding",))].shape) == \
        (N_CAT, B, DIM)
    assert ctx[pname][1] is None
    _steps_match(jt, pt, [_batch(20 + s) for s in range(3)])


@pytest.mark.parametrize("feature_major", [True, False])
def test_block_rows_matches_the_per_feature_path(monkeypatch,
                                                 feature_major):
    """The port's block path against its own per-feature path from the
    same state: the loss, the row gradients B1 receives, and three steps'
    packs and dense parameters. One B1 update a step either way."""
    _, block = _paired(_deepfm(feature_major), _batch(10), None,
                       dict(block_rows=True))
    _, flat = _paired(_deepfm(feature_major), _batch(10))
    assert not any(flat._block_mode.values())
    calls = []
    orig = pd_mod.packed_adagrad_update_plain_

    def record(pack, ids, G, grads, lr, **kw):
        calls.append([g.detach().clone() for g in grads])
        return orig(pack, ids, G, grads, lr, **kw)

    monkeypatch.setattr(pd_mod, "packed_adagrad_update_plain_", record)
    for s in range(3):
        batch = _batch(30 + s)
        _close(float(block.train_step(batch)),
               float(flat.train_step(batch)), "loss", atol=0)
        (gb, gf) = calls[-2:]
        for a, b in zip(gb, gf):
            _close(a, b, "row grads")
    assert len(calls) == 6
    for name in block.packs:
        _close(block.packs[name], flat.packs[name], name)
    for k, v in block.model.state_dict().items():
        _close(v, flat.model.state_dict()[k], k)
    # eval reads the same function through either path
    batch = _batch(40)
    batch.pop("click")
    _close(block.predict([batch]), flat.predict([batch]), "predict",
           atol=1e-5)


GATES = {
    "on": (dict(), True),
    "off_by_default": (dict(), False),
    "padding_idx": (dict(c2=dict(padding_idx=0)), False),
    "freeze_emb": (dict(c1=dict(freeze_emb=True)), False),
    "sequence": (dict(c3=dict(type="sequence", max_len=3)), False),
}


@pytest.mark.parametrize("case", list(GATES))
def test_block_gate_follows_jax(case):
    """Block mode opens only where JAX's gate opens: asked for, one pack,
    its features exactly the batch's categorical 1-D columns, none padded
    or frozen."""
    extra, want = GATES[case]
    ask = case != "off_by_default"
    batch = _batch(10)
    if case == "sequence":
        batch["c3"] = np.stack([batch["c3"]] * 3, axis=1) % (VOCAB - 1)
    jm, pm = _deepfm(False, **extra)
    jt = JPacked(jm, lambda o, b: jbce(o, b["click"]),
                 JTrainerConfig(**CFG), block_rows=ask)
    pt = PackedEmbeddingTrainer(
        pm, lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(**CFG), device="cpu", block_rows=ask)
    jt.init(batch)
    pt.init(batch)
    assert pt._block_mode == jt._block_mode
    assert any(pt._block_mode.values()) == want
    assert np.isfinite(float(pt.train_step(batch)))


# -- the split-accumulator layout --------------------------------------------------

def test_split_accumulators_dcnv2_dim128_match_jax(monkeypatch):
    """DCNv2 at dim 128: the pack holds the values alone (128 wide) and
    the AdaGrad accumulators sit in a (3·64, 1) ``accs``; three steps with
    repeated ids agree with JAX's (pack, accs, accumulators, loss). B1 is
    never called on this layout."""
    batch = _ctr_batch(10, n_cat=3)
    jt, pt = _paired(_dcnv2(), batch)
    (pname, pack), = pt.packs.items()
    assert tuple(pack.shape) == (3 * VOCAB, 128)
    assert pt._acc_in_row == {pname: False} == jt._acc_in_row
    assert tuple(pt.accs[pname].shape) == (3 * VOCAB, 1)
    called = []

    def b1(*a, **k):
        called.append(1)

    monkeypatch.setattr(packed_mod, "packed_adagrad_update_", b1)
    _steps_match(jt, pt, [_ctr_batch(20 + s, n_cat=3) for s in range(3)],
                 dense_atol=1e-5)
    assert not called
    ids = np.unique(np.concatenate([_ctr_batch(20 + s, n_cat=3)["c0"]
                                    for s in range(3)]))
    acc = pt.accumulators["embedding/emb_c0"].numpy()
    assert (acc[ids] > 0).all()
    assert (np.delete(acc, ids) == 0).all()


def test_split_layout_keeps_b1_off_its_pack():
    """B1's wrapper refuses the split layout's width (its `used` must be
    the values plus one accumulator a slot): it cannot be handed a split
    pack by mistake, on the card or here."""
    pack = torch.zeros(8, 128)
    ids = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="layout"):
        pd_mod.packed_adagrad_update_(
            pack, ids, pack[:2].clone(), [torch.zeros(2, 128)], 0.1,
            dims=(128,), acc_cols=(0,), used=128, eps=1e-8)


# -- lazy Adam ---------------------------------------------------------------------

def test_lazy_adam_deepfm_matches_jax():
    """[values | m | v] rows (3 x 9 used of 128): three steps, duplicate
    ids each updating from the pre-step state, bias correction from the
    step count; the embedding lr defaults to the learning rate."""
    jt, pt = _paired(_deepfm(True), _batch(10),
                     dict(embedding_optimizer="adam"),
                     dict(embedding_optimizer="adam"))
    (pname, pack), = pt.packs.items()
    assert pt._pack_store_width[pname] == 128 and not pt.accs
    assert pt._value_width[pname] == DIM + 1
    assert float(pack[:, DIM + 1:].abs().max()) == 0.0     # m, v from 0
    _steps_match(jt, pt, [_batch(20 + s) for s in range(3)])
    assert pt._emb_lr == jt._emb_lr == CFG["learning_rate"]
    assert float(pt.packs[pname][:, 2 * (DIM + 1):3 * (DIM + 1)].max()) > 0


def test_lazy_adam_fused_steps_match_single_steps():
    """`train_steps_fused` over K batches equals K `train_step`s (the
    bias correction reads the step count, a device tensor)."""
    _, a = _paired(_deepfm(True), _batch(10), None,
                   dict(embedding_optimizer="adam"))
    _, b = _paired(_deepfm(True), _batch(10), None,
                   dict(embedding_optimizer="adam"))
    b.model.load_state_dict(a.model.state_dict())
    for name, pack in a.packs.items():
        b.packs[name].copy_(pack)
    batches = [_batch(50 + s) for s in range(3)]
    for batch in batches:
        a.train_step(batch)
    b.train_steps_fused({k: np.stack([x[k] for x in batches])
                         for k in batches[0]})
    assert a.step == b.step == 3
    for name in a.packs:
        torch.testing.assert_close(a.packs[name], b.packs[name], rtol=0,
                                   atol=0)


# -- state, checkpoints ------------------------------------------------------------

@pytest.mark.parametrize("layout", ["split", "adam", "block"])
def test_state_dict_save_load_round_trip(tmp_path, layout):
    """The packs and ``accs`` ride in `state_dict`, `save` / `load` and the
    best-weight cache: a loaded trainer steps as the saved one."""
    if layout == "split":
        make = (lambda: _dcnv2(), lambda s: _ctr_batch(s, n_cat=3), {})
    else:
        make = (lambda: _deepfm(True), _batch,
                dict(embedding_optimizer="adam") if layout == "adam"
                else dict(block_rows=True))
    models, batch_of, kw = make
    _, a = _paired(models(), batch_of(10), None, kw)
    a.train_step(batch_of(11))
    state = a.state_dict()
    assert set(state["accs"]) == set(a.accs)
    assert bool(a.accs) == (layout == "split")
    path = str(tmp_path / "ck.pt")
    a.save(path)
    _, b = _paired(models(), batch_of(10), None, kw)
    b.load(path)
    for t in (a, b):
        t.train_step(batch_of(12))
    for name in a.packs:
        torch.testing.assert_close(a.packs[name], b.packs[name])
    for name in a.accs:
        torch.testing.assert_close(a.accs[name], b.accs[name])
    # the best-weight cache: drift, then restore the captured state
    a._capture_best()
    saved = {k: v.clone() for k, v in {**a.packs, **a.accs}.items()}
    a.train_step(batch_of(13))
    a._restore_best()
    for k, v in {**a.packs, **a.accs}.items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    bad = dict(state, accs={})
    if layout == "split":
        with pytest.raises(ValueError, match="accs"):
            b.load_state_dict(bad)


# -- pretrained and frozen tables ----------------------------------------------------

def _pretrained_maps(path, freeze, dim=4):
    def specs(S):
        return (S("item", "categorical", vocab_size=10, embedding_dim=dim,
                  pretrain_path=path, freeze_emb=freeze),)
    return JFeatureMap("pt", specs(JFeatureSpec)), \
        FeatureMap("pt", specs(FeatureSpec))


@pytest.mark.parametrize("freeze", [True, False])
def test_pretrained_table_loaded_and_frozen(tmp_path, freeze):
    """`tests/test_trainer_fixes.py:122-170` on both packages: the table
    starts at the file's matrix; frozen, no gradient reaches it (the
    port's is None, JAX's zeros); else it gets JAX's gradient."""
    path = str(tmp_path / "vecs.npz")
    vecs = np.arange(40, dtype=np.float32).reshape(10, 4)
    np.savez(path, embeddings=vecs)
    jfm, pfm = _pretrained_maps(path, freeze)
    jmod, pmod = JFeatureEmbedding(jfm), FeatureEmbedding(pfm, device="cpu")
    ids = np.arange(4)
    params = fnn.meta.unbox(jmod.init(jax.random.PRNGKey(0),
                                      {"item": ids})["params"])
    np.testing.assert_array_equal(np.asarray(params["emb_item"]), vecs)
    np.testing.assert_array_equal(pmod.tables["item"].detach().numpy(),
                                  vecs)
    jg = jax.grad(lambda p: (jmod.apply({"params": p}, {"item": ids})
                             ["item"] ** 2).sum())(params)["emb_item"]
    out = pmod({"item": torch.from_numpy(ids)})["item"]
    if freeze:
        assert not out.requires_grad
        assert float(np.abs(np.asarray(jg)).max()) == 0.0
    else:
        (pg,) = torch.autograd.grad((out ** 2).sum(), [pmod.tables["item"]])
        assert float(pg.abs().max()) > 0
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-6)


@pytest.mark.parametrize("bad", [(10, 7), (12, 4), (3, 2, 4)])
def test_pretrained_shape_errors_as_jax(tmp_path, bad):
    path = str(tmp_path / "bad.npy")
    np.save(path, np.zeros(bad, np.float32))
    jfm, pfm = _pretrained_maps(path, False)
    with pytest.raises(ValueError) as jerr:
        JFeatureEmbedding(jfm).init(jax.random.PRNGKey(0),
                                    {"item": np.arange(4)})
    with pytest.raises(ValueError) as perr:
        FeatureEmbedding(pfm, device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_pretrained_rows_beyond_the_file_keep_the_draw(tmp_path):
    path = str(tmp_path / "few.npy")
    np.save(path, np.ones((6, 4), np.float32))
    _, pfm = _pretrained_maps(path, False)
    table = FeatureEmbedding(pfm, device="cpu").tables["item"].detach()
    assert torch.all(table[:6] == 1)
    assert 0 < float(table[6:].abs().max()) < 1e-3       # normal(1e-4)


def test_frozen_table_stays_put_in_the_packed_trainer_as_jax():
    """A frozen feature's pack rows get zero row gradients (B1 adds zero
    deltas and zero g²) and the block gate stays closed; three steps
    match JAX's trainer."""
    jt, pt = _paired(_deepfm(True, c1=dict(freeze_emb=True)), _batch(10),
                     dict(block_rows=True), dict(block_rows=True))
    assert not any(pt._block_mode.values())
    before = pt.tables["embedding/emb_c1"].clone()
    _steps_match(jt, pt, [_batch(20 + s) for s in range(3)])
    torch.testing.assert_close(pt.tables["embedding/emb_c1"], before,
                               rtol=0, atol=0)
    assert float(pt.accumulators["embedding/emb_c1"].abs().max()) == 0.0
