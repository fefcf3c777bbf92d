"""The port's public surface against the JAX package's `__all__` lists.

One case a module of `recbox_tpu` (outside `ops/pallas`, whose kernels the
port exposes from `ops/`) that defines `__all__`: the port's module of the
same dotted path has each exported name, or the name is one of the three
with no counterpart by design (`NO_COUNTERPART`). For each exported
callable, the port's counterpart accepts every parameter name of JAX's,
except flax's ``parent`` / ``name`` and the params-to-module idioms of
`IDIOMS`; a counterpart that takes ``**kwargs`` accepts any name. The
modules are found by parsing the JAX sources, so the cases are the same in
every worker.
"""

import ast
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX names that the port leaves out, each with its reason in ROADMAP.md
NO_COUNTERPART = {
    "auc_jax": "Queue C 57: the on-device AUC is auc_torch",
    "StaticArray": "Queue C 42: graph arrays are non-persistent buffers",
    "training_key": "Queue C 45: the trainers own explicit Philox "
                    "generators seeded from TrainerConfig.seed",
}

# (JAX module, name): the JAX parameters that a PyTorch module or tensor
# replaces (a flax params pytree, a template pytree, a JAX PRNG choice or
# a flax param dtype)
IDIOMS = {
    ("recbox_tpu.nn", "FeatureEmbedding"): {"param_dtype"},
    ("recbox_tpu.nn.embedding", "FeatureEmbedding"): {"param_dtype"},
    ("recbox_tpu.parallel", "shard_params"): {"params"},
    ("recbox_tpu.parallel", "param_partition_specs"): {"params"},
    ("recbox_tpu.parallel.mesh", "shard_params"): {"params"},
    ("recbox_tpu.parallel.mesh", "param_partition_specs"): {"params"},
    ("recbox_tpu.retrieval.index", "quantize_int8"): {"items"},
    ("recbox_tpu.training", "load_checkpoint"): {"template"},
    ("recbox_tpu.training.checkpoint", "load_checkpoint"): {"template"},
    ("recbox_tpu.training.pretrain", "S3RecPretrainer"): {"rng_impl"},
    ("recbox_tpu.training.pretrain", "transfer_pretrained"): {
        "init_params"},
    ("recbox_tpu.training.recvae", "RecVAETrainer"): {"rng_impl"},
    ("recbox_tpu.training.sparse", "split_sparse_params"): {"params"},
}


def _defines_all(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(getattr(t, "id", None) == "__all__" for t in targets):
            return True
    return False


def _jax_modules():
    root = os.path.join(REPO, "recbox_tpu")
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        if os.path.relpath(dirpath, root).startswith(
                os.path.join("ops", "pallas")):
            continue
        for fname in sorted(filenames):
            path = os.path.join(dirpath, fname)
            if not fname.endswith(".py") or not _defines_all(path):
                continue
            mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            out.append(mod[:-len(".__init__")]
                       if mod.endswith(".__init__") else mod)
    return out


MODULES = _jax_modules()


def _param_names(obj):
    """Parameter names of ``obj`` (None when it has no signature), and
    whether it takes ``**kwargs``."""
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None, False
    kinds = {p.kind for p in sig.parameters.values()}
    names = {n for n, p in sig.parameters.items()
             if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
    return names, inspect.Parameter.VAR_KEYWORD in kinds


def test_modules_found():
    # the root, the losses and the index are among them
    assert len(MODULES) == len(set(MODULES)) >= 80
    for mod in ("recbox_tpu", "recbox_tpu.ops", "recbox_tpu.retrieval.index",
                "recbox_tpu.models", "recbox_tpu.nn", "recbox_tpu.evaluation"):
        assert mod in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_port_exports_jax_names(module):
    jmod = importlib.import_module(module)
    pmod = importlib.import_module("recbox_tpu_torch"
                                   + module[len("recbox_tpu"):])
    missing = [n for n in jmod.__all__
               if n not in NO_COUNTERPART and not hasattr(pmod, n)]
    assert not missing, f"{pmod.__name__} lacks {missing}"
    for name in jmod.__all__:
        if name in NO_COUNTERPART:
            continue
        jobj, pobj = getattr(jmod, name), getattr(pmod, name)
        if not callable(jobj):
            continue
        jnames, _ = _param_names(jobj)
        pnames, p_kwargs = _param_names(pobj)
        if jnames is None or p_kwargs:
            continue
        excused = IDIOMS.get((module, name), set())
        absent = jnames - {"parent", "name"} - (pnames or set())
        # an idiom is excused only where it applies
        assert excused <= absent, (name, excused - absent)
        assert absent == excused, f"{pmod.__name__}.{name} lacks {absent}"


def test_no_counterpart_map_is_exactly_three():
    """The names left out by design are the three of the map, and each is
    still a JAX export (a stale entry fails here)."""
    assert set(NO_COUNTERPART) == {"auc_jax", "StaticArray", "training_key"}
    exported = set()
    for module in MODULES:
        exported |= set(importlib.import_module(module).__all__)
    assert set(NO_COUNTERPART) <= exported
    from recbox_tpu_torch import evaluation
    assert callable(evaluation.auc_torch)


def test_idioms_are_thirteen_pairs():
    assert len(IDIOMS) == 13
    assert all(mod in MODULES for mod, _ in IDIOMS)
