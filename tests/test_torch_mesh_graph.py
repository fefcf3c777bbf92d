"""The graph models' own tables row-sharded under a mesh, against the JAX
package (the knowledge models: `test_torch_mesh_knowledge.py`, which
shares this file's helpers).

JAX marks the graph and knowledge models' user, item, entity and node
tables with ``nn.with_partitioning(..., (('data', 'model'), None))``; the
port marks the same tables (`parallel.mesh.shard_rows`). The propagation
models gather each table whole once a forward (`parallel.mesh.whole_table`);
the others read rows by id through the mesh's exchange
(`parallel.mesh.lookup`). This file holds:

* `param_partition_specs` against flax's partition metadata, name for name,
  for the 19 models of the six graph and knowledge files (JAX's side traced
  with `jax.eval_shape`, its names carried over by
  `interop.from_jax_params`);
* LightGCN, NGCF, GCMC and LINE taking three steps under JAX's sharded
  `Trainer` on conftest's virtual devices and under the port's four gloo
  ranks (`torch_parallel_workers.mesh_graph`, one spawn for the file's
  cases), at meshes (2, 2), (1, 4) and (4, 1), by `test_torch_mesh_tables`'
  rules (`check_steps`), and the same runs against the port's unsharded
  run by the same rules;
* SGL (its InfoNCE on fixed edge masks), NCL (its structural and prototype
  terms), DGCF and SpectralCF on a (2, 2) mesh against the port's
  unsharded run from one state, by the same rules;
* each sharded table's rows a rank, NCL's prototypes equal on every rank
  and to the unsharded ones, LightGCN's collective bytes a step equal at E
  and 2E edges and to 2·(U + I)·D·4 plus two f32 scalars, the trained
  LightGCN served on a ('model') mesh against an unsharded service, and
  `run_matching_experiment` (LightGCN) on a (2, 2) mesh against its
  unsharded run (1e-6);
* `chip_smoke.py` phase 5u rehearsed at a small width.
"""

import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh_tables as MT
import torch_parallel_workers as W
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models import knowledge as jknow
from recbox_tpu.models.knowledge import intent as jintent
from recbox_tpu.models.matching import graph as jgraph
from recbox_tpu.models.matching import graph_extended as jgext
from recbox_tpu.ops import full_softmax_loss as jfull_softmax_loss
from recbox_tpu.ops import get_matching_loss as jget_matching_loss
from recbox_tpu.parallel import make_mesh as jmake_mesh
from recbox_tpu.parallel.mesh import shard_params as jshard_params
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.parallel import mesh as M
from recbox_tpu_torch.parallel import param_partition_specs
from recbox_tpu_torch.training.trainer import is_embedding_table

MESHES = MT.MESHES           # n_model at 4 ranks: (2, 2), (1, 4), (4, 1)
CASES = W.MG_JAX + W.MG_PORT
MODELS = sorted({c.split("-")[0] for c in CASES})
# parameters whose gradient is rounding noise, the loss cancelling it: MKR's
# last cross & compress unit's item bias and GCMC's item-side encoder bias
# shift every candidate's score alike (`test_torch_knowledge.NOISE`,
# `test_torch_graph_extended`); each entry moves by up to lr a step in
# either run, so they are held to the bound of 6 lr alone
NOISE = {"MKR": ("cc1.b_v",), "GCMC": ("enc_i.bias",)}
# tables with entries whose gradient lies below 1e-4 of the table's
# largest (NGCF: an item entry at the third step; GCMC: the entries its
# ReLU gates, 46-59 of 256 item entries a step), where Adam's division by
# the gradient's root mean square turns a change in the order of a sum
# into a visible move: one or two entries a table part JAX's trainer from
# the port's without a mesh too, and a 'data' axis (a gradient summed over
# ranks) from the unsharded run. Their tables are held to the other
# parameters' rule
ROUNDING_TABLES = ("NGCF", "GCMC")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def check_steps(port, name, m, losses, params, table_rule=True):
    """`test_torch_mesh_tables`' rules: the losses of every rank at rtol
    1e-5; the tables (with ``table_rule``) at most 2e-5 of their entries
    outside rtol 1e-4 / atol 1e-6; every other entry within 6 lr, and at
    most 1% of them (``NOISE``'s aside) beyond atol 2e-5 + rtol 1e-4; every
    rank's gathered parameters equal."""
    for r in range(4):
        np.testing.assert_allclose(port[r][f"{name}/m{m}/loss"], losses,
                                   rtol=MT.LOSS_RTOL)
    got = port[0]
    assert any(is_embedding_table(k) for k in params)
    outside, entries = 0, 0
    for k, want in params.items():
        mine = got[f"{name}/m{m}/{k}"]
        assert mine.shape == want.shape, k
        if table_rule and is_embedding_table(k):
            assert MT._outside_share(mine, want) <= MT.T_OUTSIDE, (k, np.abs(
                mine - want).max())
            continue
        diff = np.abs(mine - want)
        assert diff.max() <= 6 * MT.LR, k
        if k in NOISE.get(name.split("-")[0], ()):
            continue
        outside += int((diff > MT.P_ATOL + MT.P_RTOL * np.abs(want)).sum())
        entries += want.size
    assert outside <= 0.01 * entries, (outside, entries)
    for r in range(1, 4):                   # every rank gathers alike
        for k in params:
            np.testing.assert_array_equal(port[r][f"{name}/m{m}/{k}"],
                                          got[f"{name}/m{m}/{k}"])


# -- the JAX models --------------------------------------------------------

def jmodel(name):
    """JAX's ``name`` over the world of `torch_parallel_workers`, its
    graph arrays the port's (tuples for the graph models, `StaticArray`
    for the knowledge models)."""
    graph = W.mg_case_graph(name)
    size = W.mg_size(name)
    fm = W.mg_feature_map(JFeatureMap, JFeatureSpec, size["users"],
                          size["items"])
    if name in W.MG_GRAPH:
        graph = {k: (tuple(v.tolist()) if isinstance(v, np.ndarray) else v)
                 for k, v in graph.items()}
        mod = jgraph if hasattr(jgraph, name) else jgext
    else:
        graph = {k: (jknow.StaticArray(v) if isinstance(v, np.ndarray)
                     else v) for k, v in graph.items()}
        mod = jknow if hasattr(jknow, name) else jintent
    return getattr(mod, name)(feature_map=fm, embedding_dim=W.MG_D,
                              **W.MG_KW[name], **graph)


def _inits(name, jm):
    """The flax inits whose trees together hold every parameter the
    port's model has (MKR's KG head comes from ``kg_loss``)."""
    batch = {k: jnp.asarray(v) for k, v in W.mg_batch(name).items()}
    if name == "KSR":
        return [lambda k: jm.init(k, batch, method=jm.full_scores)]
    inits = [lambda k: jm.init(k, batch)]
    if name == "MKR":
        rng = np.random.default_rng(9)
        ents = W.mg_size(name)["ents"]
        kb = {"kg_head": rng.integers(0, ents, 8),
              "kg_relation": rng.integers(1, W.MG_REL, 8),
              "kg_tail": rng.integers(0, ents, 8),
              "kg_neg_tail": rng.integers(0, ents, 8)}
        kb = {k: jnp.asarray(v.astype(np.int32)) for k, v in kb.items()}
        inits.append(lambda k: jm.init(k, kb, method=jm.kg_loss))
    return inits


def test_spec_cases_cover_the_six_files():
    """Every model of the graph and knowledge files has a case."""
    names = set(jgraph.__all__) | set(jgext.__all__) | set(jknow.__all__) \
        | set(jintent.__all__)
    names -= {"build_norm_edges", "kmeans_prototypes", "infonce",
              "infonce_all", "StaticArray"}
    assert names == set(MODELS), names ^ set(MODELS)
    assert len(MODELS) == 19


@pytest.mark.parametrize("name", MODELS)
def test_param_partition_specs_match_flax(name):
    """{port name: spec} equals flax's metadata, flattened: each JAX leaf
    filled with 1 where its spec is (('data', 'model'), None), else 0, and
    carried to the port's names by `from_jax_params`."""
    jm, pm = jmodel(name), W.mg_model(name)
    shapes = {}
    for init in _inits(name, jm):
        boxed = jax.eval_shape(init, jax.random.PRNGKey(0))["params"]
        specs = fnn.get_partition_spec(boxed)
        flat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        assert {tuple(s) for s in flat} <= {(), M.SHARDED_SPEC}, flat
        shapes.update(jax.tree_util.tree_map(
            lambda leaf, s: np.full(leaf.shape, float(tuple(s) != ()),
                                    np.float32),
            fnn.meta.unbox(boxed), specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    state = from_jax_params(shapes, pm)
    want = {k for k, v in state.items() if v.numel() and bool(v.all())}
    got = param_partition_specs(pm)
    assert set(got) == {k for k, _ in pm.named_parameters()}
    assert {k for k, s in got.items() if s} == want, name
    assert all(s == M.SHARDED_SPEC for s in got.values() if s)
    assert want, f"{name} marks no table"


# -- four gloo ranks against JAX's sharded trainer ------------------------------

def _jtrainer(name, mesh):
    if name == "KSR":
        def loss(o, b):
            return jfull_softmax_loss(o, b["item_id"])
    else:
        bpr = jget_matching_loss("PairwiseLogisticLoss")

        def loss(o, b):
            return bpr(o)
    return JTrainer(jmodel(name), loss,
                    JTrainerConfig(learning_rate=W.MG_LR, epochs=1,
                                   monitor="AUC", seed=5),
                    mesh=mesh,
                    train_method="full_scores" if name == "KSR" else None)


def _initial(name, batch):
    """JAX's initial parameters with every all-zero leaf (the dense
    biases) drawn from normal(0, 0.1): on 0.01-scale tables a zero bias
    leaves pre-activations near rounding noise, whose sign (a leaky
    ReLU's slope, a ReLU's gate) would differ between the packages."""
    jt = _jtrainer(name, None)
    jt.init(batch)
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(a.dtype)
        if not a.any() else a, _np(jt.params))


def mesh_runs(tmp, jax_cases, port_cases, pipelines=()):
    """JAX's sharded runs of ``jax_cases`` at every mesh, the port's four
    ranks from the same states (``port_cases`` at (2, 2)), and the port's
    unsharded runs of every case and of ``pipelines`` in this process:
    (JAX's {(case, n_model): (losses, params)}, the port's unsharded
    {case: (losses, params)}, the ranks' arrays, the unsharded pipelines'
    metrics, the directory of the saved states)."""
    states, initial, expect, plain = {}, {}, {}, {}
    cases = tuple(jax_cases) + tuple(port_cases)
    for name in cases:
        np.savez(tmp / f"{name}.npz", **W.mg_batch(name))
        states[name] = str(tmp / f"{name}.pt")
    for name in jax_cases:
        initial[name] = _initial(name, W.mg_batch(name))
        torch.save(from_jax_params(initial[name], W.mg_model(name)),
                   states[name])
    for name in port_cases:
        torch.manual_seed(40 + W.MG_PORT.index(name))
        torch.save(W.mg_model(name).state_dict(), states[name])
    port = []
    ranks = threading.Thread(target=lambda: port.extend(W.run(
        "mesh_graph", 4, tmp, states=states, batch_dir=str(tmp),
        meshes=list(MESHES), pipelines=tuple(pipelines))))
    ranks.start()
    try:
        for name in cases:
            batch = W.mg_batch(name)
            t, losses = W.mg_steps(name, states[name], batch, None)
            plain[name] = (losses, {k: v.detach().numpy().copy()
                                    for k, v in t.params.items()})
            if name == "NCL":
                plain["NCL/protos"] = t.model.mg_protos
            if name not in jax_cases:
                continue
            for m in MESHES:
                mesh = jmake_mesh(num_model_shards=m,
                                  devices=jax.devices()[:4])
                jt = _jtrainer(name, mesh)
                jt.init(batch)
                jt.params = jshard_params(jax.tree_util.tree_map(
                    jnp.asarray, initial[name]), mesh, jt.param_specs)
                jt.opt_state = jt.tx.init(jt.params)
                losses = [float(jt.train_step(dict(batch)))
                          for _ in range(3)]
                expect[name, m] = (losses, {
                    k: v.numpy() for k, v in from_jax_params(
                        _np(jt.params), W.mg_model(name)).items()})
        pipes = W.mg_pipelines(pipelines)
    finally:
        ranks.join()
    assert len(port) == 4, "a rank failed"
    return expect, plain, port, pipes, tmp


def check_rows(runs, name):
    """Under every mesh shape each sharded table of ``name`` keeps
    ceil(V / 4) rows on a rank and the ranks' real rows add up to V."""
    plain, port = runs[1], runs[2]
    sharded = {k.split("/local/")[1] for k in port[0]
               if k.startswith(f"{name}/m2/local/")}
    assert sharded == {k for k, s in param_partition_specs(
        W.mg_model(name)).items() if s}
    for pname in sharded:
        rows = plain[name][1][pname].shape[0]
        for m in (MESHES if name in W.MG_JAX else (2,)):
            shapes = [port[r][f"{name}/m{m}/local/{pname}"]
                      for r in range(4)]
            assert all(s[0] == -(-rows // 4) for s in shapes), (pname, shapes)
            assert sum(int(s[-1]) for s in shapes) == rows


def check_pipeline(runs, pipeline):
    port, plain = runs[2], runs[3][pipeline]
    keys = sorted(k.split("/", 2)[2] for k in port[0]
                  if k.startswith(f"pipeline/{pipeline}/"))
    assert keys == sorted(plain)
    for r in range(4):
        for k in keys:
            np.testing.assert_allclose(
                port[r][f"pipeline/{pipeline}/{k}"], plain[k], atol=1e-6,
                err_msg=k)


JAX_CASES = tuple(c for c in W.MG_JAX if c in W.MG_GRAPH)
PORT_CASES = tuple(c for c in W.MG_PORT if c in W.MG_GRAPH)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("mesh_graph"), JAX_CASES,
                     PORT_CASES, pipelines=("LightGCN",))


@pytest.mark.parametrize("name", JAX_CASES)
@pytest.mark.parametrize("m", MESHES)
def test_sharded_steps_match_jax(runs, name, m):
    """The port's four ranks against JAX's sharded trainer of the same mesh
    shape, after three steps of one global batch."""
    check_steps(runs[2], name, m, *runs[0][name, m],
                table_rule=name not in ROUNDING_TABLES)


@pytest.mark.parametrize("name", JAX_CASES)
@pytest.mark.parametrize("m", MESHES)
def test_sharded_steps_match_unsharded(runs, name, m):
    """The same ranks against the port's unsharded run from the same
    state."""
    check_steps(runs[2], name, m, *runs[1][name],
                table_rule=name not in ROUNDING_TABLES)


@pytest.mark.parametrize("name", PORT_CASES)
def test_more_sharded_routes_match_unsharded(runs, name):
    """SGL, NCL, DGCF and SpectralCF on a (2, 2) mesh against the port's
    unsharded run from one state."""
    check_steps(runs[2], name, 2, *runs[1][name])


@pytest.mark.parametrize("name", JAX_CASES + PORT_CASES)
def test_each_rank_holds_its_rows(runs, name):
    check_rows(runs, name)


def test_ncl_prototypes_equal_everywhere(runs):
    """NCL's k-means on the gathered tables: every rank's prototypes and
    assignments equal the unsharded run's."""
    plain, port = runs[1], runs[2]
    for r in range(4):
        for i, want in enumerate(plain["NCL/protos"]):
            np.testing.assert_array_equal(port[r][f"NCL/m2/protos{i}"],
                                          want)


def test_collective_bytes_have_no_edge_term(runs):
    """LightGCN on a (2, 2) mesh over 24 users x 32 items (the world
    divides both): the same collectives and bytes a step at E and 2E
    edges, 2·(U + I)·D·4 (the tables' all-gather and their gradient's
    'data' all-reduce) plus the loss's and the clip's f32 scalars."""
    port = runs[2]
    size = W.mg_size("LightGCN")
    want = 2 * (size["users"] + size["items"]) * W.MG_D * 4 + 2 * 4
    for r in range(4):
        assert int(port[r]["edges/2E"]) == 2 * int(port[r]["edges/E"])
        assert int(port[r]["bytes/E"]) == int(port[r]["bytes/2E"]) == want
        assert list(port[r]["kinds/E"]) == list(port[r]["kinds/2E"])


def test_service_on_a_model_mesh_matches_unsharded(runs):
    """The (2, 2) run's LightGCN through `RetrievalService.from_trainer`
    on a ('model') mesh of 4: every rank's top 5 of every user equal to an
    unsharded service over the gathered weights (ids; scores atol 1e-6)."""
    port = runs[2]
    for r in range(4):
        np.testing.assert_array_equal(port[r]["svc/ids"],
                                      port[r]["svc/plain_ids"])
        np.testing.assert_allclose(port[r]["svc/scores"],
                                   port[r]["svc/plain_scores"], atol=1e-6)


def test_matching_pipeline_on_a_mesh_matches_unsharded(runs):
    """`run_matching_experiment(mesh=)` over LightGCN (2 epochs,
    evaluations in batches of 16: every rank propagates for each) on a
    (2, 2) mesh gives the unsharded run's metrics (atol 1e-6)."""
    check_pipeline(runs, "LightGCN")


def test_chip_smoke_5u_two_rank_rehearsal(monkeypatch, tmp_path):
    """`chip_smoke.py` phase 5u on the CPU at a small width, in 5t(b)'s two
    gloo ranks: LightGCN's rows a rank, bytes held and recorded bytes a
    step (equal to `u_lightgcn_bytes` and over the edge list doubled),
    its losses and tables against the unsharded run, the full sort's and
    the served ids; KGAT through `run_kg_experiment` over a small
    ml1m_kg-shaped staging; KSR's forward; 5v(d)'s steps of YoutubeSBC,
    SGL, NCL and MCCLK against the unsharded ones; and the phases' own
    checks (the plain versions count no launches)."""
    import importlib
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    cs = importlib.import_module("chip_smoke")
    width = dict(SAS_V=2000, T_GLOO_BATCH=64, T_EVAL_USERS=300,
                 T_EVAL_BATCH=512, T_MI_QUERIES=16, T_MI_K=20,
                 LG_USERS=300, LG_ITEMS=400, LG_INTER=6000, LG_BATCH=64,
                 U_EVAL_USERS=100, U_SVC_USERS=16, U_EVAL_BATCH=512,
                 U_KG_BATCHES=2, U_KG_BATCH=128, U_KG_STEPS=2,
                 U_KSR_BATCH=32, N_ITEMS=2000, MI_USERS=512, MI_BATCH=64,
                 MI_NEGS=3, KG_EAGER_BATCH=128, V_PROTOS=4)
    for k, v in width.items():
        monkeypatch.setattr(cs, k, v)
    rng = np.random.default_rng(0)
    src = tmp_path / "small.inter"
    with open(src, "w") as fh:
        fh.write("user_id:token\titem_id:token\trating:float\t"
                 "timestamp:float\n")
        for u in range(60):
            for t, i in enumerate(rng.choice(80, 30, replace=False)):
                fh.write(f"{u}\t{i}\t1\t{t}\n")
    cs.stage_ml1m_kg(str(tmp_path), src=str(src))
    res = cs.mesh_tables_two_ranks(device="cpu", width=width,
                                   graph_root=str(tmp_path))
    assert cs.check_mesh_tables(res, on_card=False)
    assert cs.check_mesh_graph(res, on_card=False)
    assert cs.check_contrastive(res)
    lg = res["ranks"][0]["graph"]["lightgcn"]
    assert lg["counted_bytes"] == lg["model_bytes"]["total"] \
        == 2 * (300 + 400) * cs.LG_DIM * 4 + 8
    assert lg["table_bytes_held_unsharded"] == (300 + 400) * cs.LG_DIM * 12
    assert lg["eval_ids_bit_equal"]
