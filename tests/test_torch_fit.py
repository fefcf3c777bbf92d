"""`fit`, `train_steps_fused`, checkpoints and the DeepFM quality exit of
the port against the JAX package, on the CPU.

- `Monitor` against the JAX one over random metric sequences: the same
  values, improvements and stops exactly.
- `fit`'s control flow against JAX's `Trainer.fit` on a tiny DeepFM (the
  JAX params transplanted through `interop`, dropout 0, the same loader
  seed) with a scripted ``eval_fn``: the same evaluations (epoch, step, lr
  at each), the same early-stop and best epochs; the end weights are the
  port's own at its best evaluation bit for bit, and JAX's within rtol
  1e-4 / atol 1e-5 (f32 steps in two frameworks, with best reloads and lr
  changes on the way). Covered: per-epoch and ``eval_steps`` evaluation,
  ``fused_steps = 3`` with a tail flushed one step at a time,
  ``stop_callback``, the padded-tail ValueError and the ``valid_loader``
  TypeError.
- `train_steps_fused` against K `train_step` calls on the CPU, for the
  packed DeepFM trainer and the dense SASRec trainer (dropout 0.2 from the
  trainer's generator): losses and parameters bit for bit.
- `save` / `load` round trips (packs, embedding lr, optimizer state,
  monitor) bit for bit, and a resumed `fit` that starts at the next epoch.
- The DeepFM synthctr exit (`tools/quality_exit.py`, seed 2024, 30 epochs,
  ~5 s here) reaches a valid AUC above 0.70; the MF-BPR synth exit (seed
  2024, ~3 s) a test Recall@20 above 0.55.
- The SASRec synthseq exit through kernel B2's loss and 8-step
  `train_steps_fused` calls (its `fused` run, 3 epochs, seed 2024) takes
  the same 63 steps as the `full_scores` run and lands within 0.02 of its
  test Recall@10 and NDCG@10 (the quality exit's SASRec limit: the same CE
  with bf16 products); both above 0.5.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
from recbox_tpu.data import ArrayLoader as JArrayLoader
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.monitor import Monitor as JMonitor
from recbox_tpu_torch.data import ArrayLoader
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.models.sequential import SASRec
from recbox_tpu_torch.ops.losses import binary_crossentropy, full_softmax_loss
from recbox_tpu_torch.tools import quality_exit
from recbox_tpu_torch.training import (
    Monitor, PackedEmbeddingTrainer, Trainer, TrainerConfig,
)

N_CAT, VOCAB, DIM, B = 3, 40, 8, 64


def _specs(S):
    return tuple(S(f"c{i}", "categorical", vocab_size=VOCAB,
                   embedding_dim=DIM) for i in range(N_CAT)) \
        + (S("n0", "numeric", embedding_dim=DIM),)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    d = {f"c{i}": rng.integers(0, VOCAB, n).astype(np.int32)
         for i in range(N_CAT)}
    d["n0"] = rng.normal(size=n).astype(np.float32)
    d["click"] = ((d["c0"] % 3) == (d["c1"] % 3)).astype(np.float32)
    return d


def _port_deepfm(seed=0, hidden_units=(16,)):
    fm = FeatureMap("t", _specs(FeatureSpec), labels=("click",))
    return DeepFM(fm, embedding_dim=DIM, hidden_units=hidden_units,
                  device="cpu", generator=torch.Generator().manual_seed(seed))


def _bce(o, b):
    return binary_crossentropy(o, b["click"])


# -- the monitor ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_monitor_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mode = ("max", "min")[seed % 2]
    kv = "AUC" if seed < 3 else {"AUC": 1.0, "logloss": -0.5}
    patience = 1 + seed % 3
    jm, pm = JMonitor(kv, mode, patience), Monitor(kv, mode, patience)
    for epoch in range(30):
        # values that repeat, creep by less than min_delta, and jump
        m = {"AUC": float(np.round(rng.random(), 1)
                          + rng.choice([0.0, 5e-7, 1e-3])),
             "logloss": float(rng.random())}
        assert pm.update(m, epoch) == jm.update(m, epoch)
        assert pm.state() == jm.state()
    pm.restore({"best_value": 3.0, "best_epoch": 7, "stopping_steps": 1})
    assert pm.state()["best_epoch"] == 7
    with pytest.raises(KeyError):
        pm.get_value({"other": 1.0})
    with pytest.raises(ValueError):
        Monitor("AUC", "up")


# -- fit against JAX's ---------------------------------------------------------

# the monitored value at each evaluation: improve, plateau (lr down, best
# reloaded), improve, improve by less than min_delta, plateau, ...
SCRIPT = [0.60, 0.55, 0.70, 0.7000001, 0.65, 0.72, 0.71, 0.70, 0.69, 0.68]


class _Scripted:
    """eval_fn: SCRIPT's next value; records (epoch, step, lr) and, for the
    port, the parameters at each call."""

    def __init__(self):
        self.calls, self.params = [], []

    def __call__(self, tr):
        self.calls.append((tr.epoch, tr.step, tr.learning_rate))
        if isinstance(tr, Trainer):
            self.params.append({k: v.detach().clone()
                                for k, v in tr.params.items()})
        return {"AUC": SCRIPT[len(self.calls) - 1]}


def _fit_pair(cfg_kw, n_rows=8 * B, stop_after=None):
    data = _data(n_rows)
    jfm = JFeatureMap("t", _specs(JFeatureSpec), labels=("click",))
    jm = JDeepFM(feature_map=jfm, embedding_dim=DIM, hidden_units=(16,))
    jev, pev = _Scripted(), _Scripted()
    cfg = dict(learning_rate=1e-2, epochs=6, patience=2, monitor="AUC",
               lr_decay_factor=0.5, **cfg_kw)
    jt = JTrainer(jm, lambda o, b: jbce(o, b["click"]), JTrainerConfig(**cfg),
                  eval_fn=jev)
    pt = Trainer(_port_deepfm(), _bce, TrainerConfig(**cfg), eval_fn=pev,
                 device="cpu")
    jl = JArrayLoader(data, batch_size=B, drop_last=True, seed=3)
    pl_ = ArrayLoader(data, batch_size=B, drop_last=True, seed=3)
    jt.init(pl_.peek_batch())
    params = jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(jt.params))
    pt.model.load_state_dict(from_jax_params(params, pt.model))
    if stop_after is not None:
        for t in (jt, pt):
            t.stop_callback = (lambda polls: lambda: next(polls) >= stop_after
                               )(iter(range(10 ** 6)))
    jout, pout = jt.fit(jl), pt.fit(pl_)
    return jt, pt, jev, pev, jout, pout


def _assert_same_run(jt, pt, jev, pev, jout, pout):
    assert [c[:2] for c in pev.calls] == [c[:2] for c in jev.calls]
    np.testing.assert_allclose([c[2] for c in pev.calls],
                               [c[2] for c in jev.calls], rtol=1e-7)
    assert pout == jout
    assert (pt.epoch, pt.step) == (jt.epoch, jt.step)
    assert pt.monitor.state() == jt.monitor.state()
    np.testing.assert_allclose(pt.learning_rate, jt.learning_rate,
                               rtol=1e-7)
    expect = from_jax_params(jax.tree_util.tree_map(
        np.asarray, fnn.meta.unbox(jt.params)), pt.model)
    for k, v in pt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("cfg_kw", [
    dict(),                                    # per epoch, one step a call
    dict(fused_steps=3),                       # 8 batches: 3 + 3, tail 2
    dict(eval_steps=5),
    dict(eval_steps=5, fused_steps=3),
], ids=["epoch", "fused3", "eval_steps", "eval_steps_fused3"])
def test_fit_control_flow_matches_jax(cfg_kw):
    jt, pt, jev, pev, jout, pout = _fit_pair(cfg_kw)
    _assert_same_run(jt, pt, jev, pev, jout, pout)
    # early stop before the last epoch, and at least one plateau on the way
    assert len(pev.calls) < len(SCRIPT)
    assert min(c[2] for c in pev.calls) < pev.calls[0][2]
    # the end weights are the best evaluation's
    best = int(np.argmax([SCRIPT[i] if SCRIPT[i] > max(SCRIPT[:i] + [0]) +
                          1e-6 else -1 for i in range(len(pev.calls))]))
    for k, v in pt.params.items():
        assert torch.equal(v, pev.params[best][k]), k


def test_fit_stop_callback_matches_jax():
    jt, pt, jev, pev, jout, pout = _fit_pair({}, stop_after=13)
    _assert_same_run(jt, pt, jev, pev, jout, pout)
    assert pt.step == 13 and len(pev.calls) == 1


def test_fit_rejects_padding_loader_and_valid_loader():
    t = Trainer(_port_deepfm(), _bce, TrainerConfig(), device="cpu")
    with pytest.raises(ValueError, match="drop_last=True"):
        t.fit(ArrayLoader(_data(B + 5), batch_size=B, drop_last=False))
    with pytest.raises(TypeError, match="eval_fn"):
        t.fit(ArrayLoader(_data(B), batch_size=B), valid_loader=[])


def test_fit_raises_on_nan_loss():
    t = Trainer(_port_deepfm(), lambda o, b: o.sum() * float("nan"),
                TrainerConfig(epochs=1), device="cpu")
    with pytest.raises(ValueError, match="nan loss at epoch 0"):
        t.fit(ArrayLoader(_data(2 * B), batch_size=B, drop_last=True))


# -- train_steps_fused against train_step -------------------------------------

def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _batches(k, seed=5):
    d = _data(k * B, seed)
    return [{n: v[i * B:(i + 1) * B] for n, v in d.items()}
            for i in range(k)]


def test_packed_train_steps_fused_equals_train_steps():
    batches = _batches(4)
    a, b = (PackedEmbeddingTrainer(_port_deepfm(), _bce,
                                   TrainerConfig(learning_rate=1e-2),
                                   device="cpu") for _ in range(2))
    la = torch.stack([a.train_step(x) for x in batches])
    lb = b.train_steps_fused(_stack(batches))
    assert lb.shape == (4,) and torch.equal(la, lb)
    assert a.step == b.step == 4
    (name,) = a.packs
    assert torch.equal(a.packs[name], b.packs[name])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert a._graph_token() == b._graph_token() == 5e-2


def _sasrec_trainer():
    fm = FeatureMap("s", (FeatureSpec("item_id", "categorical",
                                      vocab_size=30, embedding_dim=16),),
                    corpus_index="item_id", num_items=30)
    model = SASRec(fm, embedding_dim=16, max_seq_len=6, n_layers=1,
                   n_heads=2, dropout=0.2, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    return Trainer(model, lambda o, b: full_softmax_loss(o, b["item_id"]),
                   TrainerConfig(learning_rate=1e-2, seed=9), device="cpu",
                   train_method="full_scores")


def test_dense_train_steps_fused_equals_train_steps():
    rng = np.random.default_rng(6)
    batches = [{"item_seq": rng.integers(1, 30, (16, 6)).astype(np.int32),
                "seq_len": np.full(16, 6, np.int32),
                "item_id": rng.integers(1, 30, 16).astype(np.int32)}
               for _ in range(3)]
    a, b = _sasrec_trainer(), _sasrec_trainer()
    la = torch.stack([a.train_step(x) for x in batches])
    lb = b.train_steps_fused(_stack(batches))
    assert torch.equal(la, lb) and b.step == 3
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert b._graph_token() is None


# -- checkpoints ----------------------------------------------------------------

def test_packed_save_load_round_trip(tmp_path):
    batches = _batches(3)
    t = PackedEmbeddingTrainer(_port_deepfm(), _bce,
                               TrainerConfig(learning_rate=1e-2),
                               device="cpu")
    for x in batches:
        t.train_step(x)
    t._on_plateau()                  # lr and emb_lr x 0.1
    t.monitor.update({"AUC": 0.7}, 0)
    t.epoch = 1
    t.save(str(tmp_path / "ckpt"))
    assert not (tmp_path / "ckpt.tmp").exists()
    fresh = PackedEmbeddingTrainer(_port_deepfm(seed=4), _bce,
                                   TrainerConfig(learning_rate=1e-2),
                                   device="cpu")
    fresh.init(batches[0])
    (name,) = t.packs
    pack = fresh.packs[name]
    fresh.load(str(tmp_path / "ckpt"))
    assert fresh.packs[name] is pack            # loaded in place
    assert torch.equal(pack, t.packs[name])
    for k in t.params:
        assert torch.equal(fresh.params[k], t.params[k]), k
    for key, value in t._opt.state_dict().items():
        got = fresh._opt.state_dict()[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(got, value), key
        else:
            assert all(torch.equal(x, y) for x, y in zip(got, value)), key
    assert fresh._emb_lr == t._emb_lr == pytest.approx(5e-3)
    assert fresh.learning_rate == t.learning_rate
    assert (fresh.step, fresh.epoch) == (3, 1)
    assert fresh.monitor.state() == t.monitor.state()
    probe = dict(batches[0])
    probe.pop("click")
    assert np.array_equal(fresh.predict([dict(probe)]),
                          t.predict([dict(probe)]))
    # the best cache is seeded from the checkpoint
    assert torch.equal(fresh._best_packs[name], pack)
    with pytest.raises(RuntimeError, match="init"):
        PackedEmbeddingTrainer(_port_deepfm(), _bce, TrainerConfig(),
                               device="cpu").load(str(tmp_path / "ckpt"))


def test_load_refuses_other_shapes(tmp_path):
    t = Trainer(_port_deepfm(), _bce, TrainerConfig(), device="cpu")
    t.train_step(_batches(1)[0])
    t.save(str(tmp_path / "ckpt"))
    other = Trainer(_port_deepfm(), _bce,
                    TrainerConfig(optimizer="sgd"), device="cpu")
    other.init(_batches(1)[0])
    with pytest.raises(ValueError, match="optimizer state"):
        other.load(str(tmp_path / "ckpt"))
    fewer = Trainer(_port_deepfm(hidden_units=(8,)), _bce, TrainerConfig(),
                    device="cpu")
    fewer.init(_batches(1)[0])
    with pytest.raises(ValueError, match="does not fit"):
        fewer.load(str(tmp_path / "ckpt"))


def test_resumed_fit_starts_at_next_epoch(tmp_path):
    data = _data(4 * B)
    evals = []

    def make(seed):
        return Trainer(_port_deepfm(seed), _bce,
                       TrainerConfig(learning_rate=1e-2, epochs=4,
                                     patience=5,
                                     workdir=str(tmp_path)),
                       eval_fn=lambda tr: evals.append(tr.epoch) or
                       {"AUC": 0.5 + 0.1 * tr.epoch}, device="cpu")

    t = make(0)
    t.fit(ArrayLoader(data, batch_size=B, drop_last=True), epochs=2)
    assert evals == [0, 1] and t.epoch == 2
    # best.ckpt is written by the evaluation, inside its epoch (as in JAX);
    # a checkpoint saved after fit resumes at the next epoch
    assert torch.load(tmp_path / "best.ckpt")["epoch"] == 1
    t.save(str(tmp_path / "end.ckpt"))
    resumed = make(3)
    resumed.init(ArrayLoader(data, batch_size=B).peek_batch())
    resumed.load(str(tmp_path / "end.ckpt"))
    assert (resumed.epoch, resumed.step) == (2, 8)
    resumed.fit(ArrayLoader(data, batch_size=B, drop_last=True))
    assert evals == [0, 1, 2, 3] and resumed.step == 16


def test_apply_methods_and_train_flag():
    t = _sasrec_trainer()
    batch = {"item_seq": np.ones((4, 6), np.int32),
             "seq_len": np.full(4, 6, np.int32)}
    t.init({**batch, "item_id": np.ones(4, np.int32)})
    by_name = t.apply(batch, method="full_scores")
    bound = t.apply(batch, method=t.model.full_scores)
    assert by_name.shape == (4, 30) and torch.equal(by_name, bound)
    assert not by_name.requires_grad and not t.model.training
    with pytest.raises(NotImplementedError, match="train=True"):
        t.apply(batch, method="full_scores", train=True)


# -- the quality exit ---------------------------------------------------------

def test_deepfm_synthctr_exit_learns(tmp_path):
    res = quality_exit.run_deepfm(quality_exit.gen_ctr(str(tmp_path)), 2024,
                                  "cpu")
    assert res["valid"]["AUC"] > 0.70, res
    assert res["test"]["AUC"] > 0.70, res


def test_sasrec_synthseq_exit_through_fused_ce_and_fused_steps(tmp_path):
    data_dir = quality_exit.gen_seq(str(tmp_path))
    runs = [quality_exit.run_sasrec(data_dir, 2024, "cpu", epochs=3,
                                    fused=fused) for fused in (False, True)]
    assert runs[0]["steps"] == runs[1]["steps"] == 63, runs
    for k in ("Recall10", "NDCG10"):
        assert abs(runs[1]["test"][k] - runs[0]["test"][k]) < 0.02, runs
        assert runs[1]["test"][k] > 0.5, runs


def test_bpr_synth_exit_learns(tmp_path):
    """The MF-BPR synth exit at seed 2024, 30 epochs (early stop, patience
    10; ~3 s here): test Recall@20 above 0.55, below the lowest of the
    port's five CPU seeds (0.5783, seed 4; JAX's median 0.5917)."""
    res = quality_exit.run_bpr(quality_exit.gen_synth(str(tmp_path)), 2024,
                               "cpu")
    assert res["test"]["Recall(k=20)"] > 0.55, res
    assert res["test"]["NDCG(k=20)"] > 0.2, res
