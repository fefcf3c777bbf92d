"""`PackedEmbeddingTrainer` with sequence features and shared tables,
against the JAX package's packed trainer, on the CPU.

The two packed-trainer cases of JAX's own tests that put a behaviour
sequence through the pack (`tests/test_packed_training.py:121`, DeepFM
over ``item_id`` and a 4-long ``hist`` that shares its table; `:382`,
DIN's target attention over a 6-long ``hist``), mirrored: both trainers
start from JAX's params and packs (`interop.load_packed_state`) and take
three steps on the same batches, the port's row update on B1's plain
version, JAX's on its Pallas kernel in interpret mode. The histories carry
PAD runs (pre-padded, all on the PAD row) and repeated ids, so each step's
rows hold duplicate ids whose deltas B1 sums: (B, L) ``hist`` rows and (B,)
``item_id`` rows land in one bundle, their gradients back in
`_slot_grads`' order. Compared: the losses, the packs and the dense
weights.

Tolerances: losses rtol 1e-5; packs and dense weights rtol 1e-4 (atol
1e-5) after AdaGrad and Adam steps at lr 1e-2 (`tests/test_torch_ctr_zoo.py`'s
packed rule); the dense Adam step by `check_adam_state` where a
weight's true gradient is 0 (`tests/test_torch_sequence_ctr.py`).
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
from recbox_tpu.models.ranking.sequence_ctr import DIN as JDIN
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.packed import PackedEmbeddingTrainer as JPacked
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import load_packed_state
from recbox_tpu_torch.models.ranking import DIN, DeepFM
from recbox_tpu_torch.ops.losses import binary_crossentropy
from recbox_tpu_torch.training import PackedEmbeddingTrainer, TrainerConfig
from test_torch_sequence_ctr import check_adam_state

VOCAB = 32


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _specs(S, length):
    return (S("item_id", "categorical", vocab_size=VOCAB + 1,
              embedding_dim=8),
            S("hist", "sequence", vocab_size=VOCAB + 1, embedding_dim=8,
              max_len=length, padding_idx=VOCAB, share_embedding="item_id"))


def _batches(seed, length, n=3, b=128):
    """Histories with PAD runs at the front (up to half the row) and ids
    from a small range (repeats); click iff the target is in the
    history."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        hist = rng.integers(1, VOCAB, (b, length)).astype(np.int32)
        pads = rng.integers(0, length // 2 + 1, b)
        hist[np.arange(length)[None, :] < pads[:, None]] = VOCAB
        target = rng.integers(1, VOCAB, b).astype(np.int32)
        out.append({"item_id": target, "hist": hist,
                    "click": (hist == target[:, None]).any(1).astype(
                        np.float32)})
    return out


CASES = {
    # tests/test_packed_training.py:121: DeepFM, one bundle of the
    # embedding and linear tables of the shared item vocabulary
    "deepfm_shared_sequence": (
        4, lambda fm, P: (JDeepFM(feature_map=fm, embedding_dim=8,
                                  hidden_units=(16,)) if P is None else
                          DeepFM(fm, embedding_dim=8, hidden_units=(16,),
                                 device="cpu"))),
    # tests/test_packed_training.py:382: DIN's target attention over the
    # shared-table history
    "din_attention": (
        6, lambda fm, P: (JDIN(feature_map=fm, embedding_dim=8,
                               hidden_units=(32,),
                               attention_hidden_units=(16,))
                          if P is None else
                          DIN(fm, embedding_dim=8, hidden_units=(32,),
                              attention_hidden_units=(16,), device="cpu"))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_sequence_three_steps_match_jax(case):
    length, build = CASES[case]
    jfm = JFeatureMap("seqpk", _specs(JFeatureSpec, length),
                      labels=("click",))
    pfm = FeatureMap("seqpk", _specs(FeatureSpec, length),
                     labels=("click",))
    cfg = dict(learning_rate=1e-2, monitor="AUC")
    jt = JPacked(build(jfm, None), lambda o, b: jbce(o, b["click"]),
                 JTrainerConfig(**cfg), delta_kernel="pallas")
    pt = PackedEmbeddingTrainer(
        build(pfm, True), lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(**cfg), device="cpu")
    batches = _batches(7, length)
    jt.init(batches[0])
    pt.init(batches[0])
    assert list(pt.packs) == list(jt.packs)
    for name in pt.packs:
        assert tuple(pt.packs[name].shape) == tuple(jt.packs[name].shape)
        assert [(s.module_path, s.dim, s.acc_col) for s in pt._slots[name]] \
            == [(s.module_path, s.dim, s.acc_col) for s in jt._slots[name]]
    load_packed_state(pt, _np_tree(jt.params),
                      {k: np.array(v) for k, v in jt.packs.items()},
                      _np_tree(jt.model_state))
    assert bool(jt.model_state) == (case == "din_attention")
    for b in batches:
        np.testing.assert_allclose(float(pt.train_step(b)),
                                   float(jt.train_step(b)), rtol=1e-5)
    for name, pack in pt.packs.items():
        np.testing.assert_allclose(pack.numpy(), np.asarray(jt.packs[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    check_adam_state(pt.model, {"params": _np_tree(jt.params),
                                **_np_tree(jt.model_state)}, 1e-2)


def test_din_packed_bundles_hist_and_target_rows():
    """DIN's pack holds one table for ``item_id`` and the shared ``hist``:
    a step gathers 128 target rows and 128 x 6 history rows from it, PAD
    runs included."""
    pfm = FeatureMap("seqpk", _specs(FeatureSpec, 6), labels=("click",))
    t = PackedEmbeddingTrainer(
        CASES["din_attention"][1](pfm, True),
        lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(learning_rate=1e-2, monitor="AUC"), device="cpu")
    b = _batches(8, 6, n=1)[0]
    t.init(b)
    (name, pack), = t.packs.items()
    assert tuple(pack.shape)[0] == VOCAB + 1
    pad_before = pack[VOCAB].clone()
    t.train_step(b)
    # the PAD row's value columns take no gradient: its rows are masked
    dim = t._slots[name][0].dim
    assert torch.equal(t.packs[name][VOCAB, :dim], pad_before[:dim])
    assert (b["hist"] == VOCAB).sum() > 0
