"""The port's examples (`recbox_tpu_torch/examples/`) on the CPU: the
ranking scripts, and `big_vocab_packed` paired with JAX's run.

Each case runs an example's ``main(device="cpu")``, whose own ``assert``
(kept from JAX's script) must hold, and checks what it returns. The paired
case builds `big_vocab_packed`'s trainer at its own size, puts JAX's
initial dense params and pack into it (`interop.load_packed_state`), and
holds its 8 losses and final pack to JAX's `PackedEmbeddingTrainer`
(direct init, JAX's B1 in Pallas interpret mode) at
`tests/test_torch_training.py`'s rtol 1e-5 / atol 1e-6.
"""

import ast
import importlib
import inspect

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.packed import PackedEmbeddingTrainer as JPacked
from recbox_tpu_torch.examples import EXAMPLES, big_vocab_packed
from recbox_tpu_torch.interop import load_packed_state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the examples take many small steps, and the
    suite's workers share the host's cores (more threads only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_big_vocab_packed_runs():
    out = big_vocab_packed.main(device="cpu")
    # 6 vocabularies of 10,000 rows; 16 + 1 values and 2 accumulators in
    # a 128-wide row
    assert out["pack_shape"] == (60_000, 128)
    assert len(out["losses"]) == 8 and all(np.isfinite(out["losses"]))


def test_big_vocab_packed_paired_with_jax():
    trainer, batch = big_vocab_packed.build(device="cpu")
    jfm = JFeatureMap("demo_big", tuple(
        JFeatureSpec(f"c{i}", "categorical", vocab_size=big_vocab_packed.VOCAB,
                     embedding_dim=big_vocab_packed.DIM)
        for i in range(big_vocab_packed.NUM_CAT)), labels=("click",))
    jt = JPacked(
        JDeepFM(feature_map=jfm, embedding_dim=big_vocab_packed.DIM,
                hidden_units=(64, 32)),
        lambda o, b: jbce(o, b["click"]),
        JTrainerConfig(learning_rate=1e-3, monitor="AUC"),
        direct_init=True, delta_kernel="pallas")
    jt.init(batch)
    trainer.init(batch)
    # no table of the port's model was ever drawn: only the packs hold one
    assert not any(".tables." in n for n, _ in trainer.model.named_parameters())
    dense = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                   fnn.meta.unbox(jt.params))
    load_packed_state(trainer, dense,
                      {k: np.array(v) for k, v in jt.packs.items()})
    jl = [float(jt.train_step(dict(batch)))
          for _ in range(big_vocab_packed.STEPS)]
    pl = [float(trainer.train_step(dict(batch)))
          for _ in range(big_vocab_packed.STEPS)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    (name, jpack), = jt.packs.items()
    np.testing.assert_allclose(trainer.packs[name].numpy(), np.asarray(jpack),
                               rtol=1e-5, atol=1e-6)


def test_ranking_deepfm():
    from recbox_tpu_torch.examples import ranking_deepfm
    assert ranking_deepfm.main(device="cpu")["AUC"] > 0.6


def test_multitask_mmoe():
    from recbox_tpu_torch.examples import multitask_mmoe
    out = multitask_mmoe.main(device="cpu")
    assert out["click_AUC"] > 0.8 and out["conversion_AUC"] > 0.8


def _public_imports(module):
    """(module, name) of every ``from recbox_tpu_torch... import name`` in
    an example's source."""
    tree = ast.parse(inspect.getsource(module))
    return [(node.module, alias.name) for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom)
            and (node.module or "").startswith("recbox_tpu_torch")
            for alias in node.names]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_public_names_only(name):
    """An example reaches the port only through names in a module's
    ``__all__``, and never imports JAX or the JAX package."""
    module = importlib.import_module(f"recbox_tpu_torch.examples.{name}")
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] in ("os", "tempfile", "zipfile",
                                                "numpy", "argparse")
                       for a in node.names), ast.dump(node)
        if isinstance(node, ast.ImportFrom):
            assert node.module.split(".")[0] in (
                "__future__", "typing", "numpy", "recbox_tpu_torch"), \
                node.module
    for mod, item in _public_imports(module):
        assert item in importlib.import_module(mod).__all__, (mod, item)
