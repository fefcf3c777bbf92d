"""The port's mesh training against the JAX package's, on the CPU.

Mirrors `tests/test_parallel.py`: the mesh shapes, row-sharded tables and
their local shards, sharded against unsharded steps of `Trainer`,
`PackedEmbeddingTrainer` and `SparseEmbeddingTrainer` (also with one
field's tables replicated, 'sparse-mixed'), `train_steps_fused`
under a mesh, and collective bytes that scale with the batch and not with
the vocabulary. JAX runs on conftest's virtual devices in this process
(``make_mesh(num_model_shards=m, devices=jax.devices()[:4])``); the port's
four ranks are gloo processes (`torch_parallel_workers`). Both start from
JAX's initial parameters (`interop.from_jax_params`) and take three steps
of one global batch of 64 rows (`test_sharded_steps_match_jax` states the
tolerances).
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

import torch_parallel_workers as W
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.parallel import make_mesh as jmake_mesh
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.packed import PackedEmbeddingTrainer as JPacked
from recbox_tpu.training.sparse import SparseEmbeddingTrainer as JSparse
from recbox_tpu_torch.interop import from_jax_params

MESHES = (2, 4, 1)             # n_model at 4 ranks: (2, 2), (1, 4), (4, 1)
KINDS = ("dense", "packed", "sparse", "sparse-mixed")
JKINDS = {"dense": JTrainer, "packed": JPacked, "sparse": JSparse,
          "sparse-mixed": JSparse}


def _batch(seed=1, n=64, vocab=64):
    rng = np.random.default_rng(seed)
    return {"cat_a": rng.integers(1, vocab, n).astype(np.int32),
            "cat_b": rng.integers(1, vocab, n).astype(np.int32),
            "click": (rng.random(n) > 0.5).astype(np.float32)}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _jax_trainer(kind, mesh, **cfg):
    fm = W.feature_map(JFeatureSpec, JFeatureMap,
                       shard=W.PLACEMENTS.get(kind, (None, None)))
    model = JDeepFM(feature_map=fm, embedding_dim=16, hidden_units=(16,))
    return JKINDS[kind](model, lambda o, b: jbce(o, b["click"]),
                        JTrainerConfig(learning_rate=1e-2, epochs=1,
                                       monitor="AUC", seed=5, **cfg),
                        mesh=mesh)


def _jax_run(kind, mesh, batch):
    jt = _jax_trainer(kind, mesh)
    jt.init(batch)
    losses = [float(jt.train_step(dict(batch))) for _ in range(3)]
    params = {k: v.numpy() for k, v in from_jax_params(
        _np(jt.full_params()), W.deepfm()).items()}
    return losses, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's unsharded and sharded runs of every (kind, mesh), the port's
    unsharded run in this process and its sharded runs in four ranks, all
    from JAX's initial state; the port's fused / refusal checks."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    batch = _batch()
    np.savez(tmp / "batch.npz", **batch)
    jt = _jax_trainer("dense", None)
    jt.init(batch)
    state_path = str(tmp / "state.pt")
    torch.save(from_jax_params(_np(jt.params), W.deepfm()), state_path)
    expect, plain = {}, {}
    for kind in KINDS:
        expect[kind, None] = _jax_run(kind, None, batch)
        t = W.make_trainer(kind, W.deepfm(
            state_path, shard=W.PLACEMENTS.get(kind, (None, None))), None)
        t.init(batch)
        plain[kind] = ([float(t.train_step(dict(batch))) for _ in range(3)],
                       W.whole_params(t))
    for m in MESHES:
        mesh = jmake_mesh(num_model_shards=m, devices=jax.devices()[:4])
        for kind in KINDS:
            expect[kind, m] = _jax_run(kind, mesh, batch)
    port = W.run("trainer_steps", 4, tmp, state_path=state_path,
                 batch_path=str(tmp / "batch.npz"), meshes=list(MESHES),
                 kinds=list(KINDS))
    misc = W.run("fused_and_errors", 4, tmp, state_path=state_path,
                 batch_path=str(tmp / "batch.npz"))
    return expect, plain, port, misc, state_path


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", MESHES)
def test_sharded_steps_match_jax(runs, kind, m):
    """The port's sharded steps against JAX's sharded steps of the same mesh
    shape, after three, on what JAX's test holds: the global loss of each
    step (rtol 1e-4) and the tables, gathered whole (rtol 1e-4 / atol
    1e-6). The tables are held to the port's own unsharded run (what
    sharding changes) and to JAX's sharded run beyond the distance the two
    packages' UNSHARDED runs already have: Adam on the dense trainer's
    tables divides near-zero gradients' rounding, up to ~3e-5 there
    without any mesh. (The dense layers' Adam steps amplify the order of a
    sum the same way; the later steps' losses carry them.)"""
    expect, plain, port, _, _ = runs
    losses, params = expect[kind, m]
    _, jplain = expect[kind, None]
    for r in range(4):
        np.testing.assert_allclose(port[r][f"{kind}/m{m}/loss"], losses,
                                   rtol=1e-4)
        np.testing.assert_allclose(port[r][f"{kind}/m{m}/loss"],
                                   plain[kind][0], rtol=1e-4)
    got = port[0]
    tables = [n for n in params if ".tables." in n]
    assert len(tables) == 4
    for name in tables:
        want, ref = params[name], plain[kind][1][name]
        mine = got[f"{kind}/m{m}/{name}"]
        np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        gap = np.abs(ref - jplain[name])
        assert np.all(np.abs(mine - want)
                      <= gap + 1e-4 * np.abs(want) + 1e-6), name
    # every rank gathers the same whole state
    for r in range(1, 4):
        for name in params:
            np.testing.assert_array_equal(port[r][f"{kind}/m{m}/{name}"],
                                          got[f"{kind}/m{m}/{name}"])


@pytest.mark.parametrize("m", MESHES)
def test_embedding_tables_row_sharded(runs, m):
    """The spec row-shards tables over the combined grid, and each rank
    holds 64 / 4 rows of each, whatever the mesh's shape."""
    _, _, port, _, _ = runs
    for r in range(4):
        assert tuple(port[r][f"dense/m{m}/local_shape"]) == (16, 16)
        assert port[r][f"dense/m{m}/spec"][0] == "(('data', 'model'), None)"


def test_mesh_shape_and_refusals(runs):
    _, _, _, misc, _ = runs
    for r in range(4):
        assert tuple(misc[r]["mesh_shape"]) == (2, 2)
        assert bool(misc[r]["undivisible_raised"])
        # a rank of the other 'model' coordinate passed other rows: every
        # rank of the pair refuses
        assert bool(misc[r]["mismatch_raised"])


def test_train_steps_fused_under_mesh(runs):
    """K eager steps under a mesh: the losses of K `train_step` calls."""
    _, _, _, misc, _ = runs
    for r in range(4):
        assert misc[r]["fused"].shape == (2,)
        assert int(misc[r]["fused_step"]) == 2
        np.testing.assert_allclose(misc[r]["fused"], misc[r]["eager"],
                                   rtol=1e-6)


def test_param_partition_specs_match_jax():
    """{name: spec} equals flax's partition metadata, flattened, for
    DeepFM with one replicated and one sharded table."""
    from recbox_tpu_torch.parallel import param_partition_specs
    jfm = W.feature_map(JFeatureSpec, JFeatureMap, shard=(False, None))
    jm = JDeepFM(feature_map=jfm, embedding_dim=16, hidden_units=(16,))
    v = jm.init(jax.random.PRNGKey(0), _batch())
    jspecs = fnn.get_partition_spec(v["params"])
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    pm = W.deepfm(shard=(False, None))
    specs = param_partition_specs(pm)
    assert len(specs) == len(flat)
    sharded = {k for k, s in specs.items() if s}
    jsharded = {k.replace("/emb_", ".tables.") for k, s in flat.items() if s}
    assert sharded == jsharded == {"embedding.tables.cat_b",
                                   "linear.tables.cat_b"}
    assert all(specs[k] == flat[k.replace(".tables.", "/emb_")]
               == (("data", "model"), None) for k in sharded)


def test_parallel_exports_jax_all():
    import recbox_tpu.parallel as jp
    import recbox_tpu_torch.parallel as tp
    assert tp.__all__ == jp.__all__
    assert all(hasattr(tp, n) for n in tp.__all__)


def test_collective_bytes_scale_with_batch_not_vocab(tmp_path):
    """The exchange is id/row-shaped: an 8x vocabulary grows a step's
    collective bytes by at most 1.25x (here not at all)."""
    res = W.run("comm_bytes", 4, tmp_path, cases=[("sharded", 2)],
                vocab=512, small=512, batch_rows=64, dim=16, hidden=(16,))
    res8 = W.run("comm_bytes", 4, tmp_path, cases=[("sharded", 2)],
                 vocab=4096, small=4096, batch_rows=64, dim=16, hidden=(16,))
    small = int(res[0]["sharded/m2/bytes"])
    big = int(res8[0]["sharded/m2/bytes"])
    assert small > 0
    assert big <= small * 1.25, (small, big)


def test_host_shard_loader_one_process(tmp_path):
    """Without a process group: one process, which reads every shard."""
    from recbox_tpu_torch.data import save_shards
    from recbox_tpu_torch.parallel.distributed import (
        host_shard_loader, process_info,
    )
    rng = np.random.default_rng(0)
    save_shards(str(tmp_path), {"a": rng.integers(0, 9, 600)
                                .astype(np.int32)}, rows_per_shard=200)
    assert process_info() == {"process_index": 0, "process_count": 1,
                              "local_devices": 1, "global_devices": 1}
    loader = host_shard_loader(str(tmp_path), batch_size=100, shuffle=False)
    assert sum(int(b["__mask__"].sum()) for b in loader) == 600


def test_every_collective_goes_through_the_mesh_wrappers():
    """The recorder sees every collective: no module of the port but
    `parallel/mesh.py` calls torch.distributed's all_* / reduce_scatter* /
    all_to_all* itself."""
    import pathlib
    import re
    import recbox_tpu_torch
    pkg = pathlib.Path(recbox_tpu_torch.__file__).parent
    call = re.compile(r"\b(?:dist|distributed)\.(?:all_\w+|reduce_scatter\w*"
                      r"|all_to_all\w*)\s*\(")
    found = [f"{p.relative_to(pkg)}:{i}" for p in sorted(pkg.rglob("*.py"))
             if p != pkg / "parallel" / "mesh.py"
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if call.search(line)]
    assert not found, found
    assert call.search((pkg / "parallel" / "mesh.py").read_text())


def test_packed_layouts_under_mesh(tmp_path):
    """Lazy Adam, block rows and split accumulators on a (2, 2) mesh equal
    the port's unsharded run of each (rtol 1e-4 / atol 1e-6 after 3 steps:
    the owner updates its rows from every occurrence)."""
    batch = _batch(seed=4)
    np.savez(tmp_path / "batch.npz", **batch)
    states, want = {}, {}
    for name, (dim, _) in W.LAYOUTS.items():
        torch.manual_seed(11)
        states[name] = str(tmp_path / f"{name}.pt")
        torch.save(W.deepfm(dim=dim).state_dict(), states[name])
        t = W.packed_layout(name, states[name])
        t.init(batch)
        want[name] = ([float(t.train_step(dict(batch))) for _ in range(3)],
                      {k: v.numpy().copy() for k, v in t.tables.items()},
                      {k: v.numpy().copy()
                       for k, v in t.accumulators.items()})
        assert bool(t.accs) == (name == "split_accumulators")
        assert any(t._block_mode.values()) == (name == "block_rows")
    got = W.run("packed_layouts", 4, tmp_path, states=states,
                batch_path=str(tmp_path / "batch.npz"))[0]
    for name, (losses, tables, accs) in want.items():
        assert bool(got[f"{name}/split"]) == (name == "split_accumulators")
        assert bool(got[f"{name}/block"]) == (name == "block_rows")
        np.testing.assert_allclose(got[f"{name}/loss"], losses, rtol=1e-5)
        for kind, ref in (("table", tables), ("acc", accs)):
            for k, v in ref.items():
                np.testing.assert_allclose(got[f"{name}/{kind}/{k}"], v,
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name} {k}")
