"""A model's own tables row-sharded under a mesh, against the JAX package.

JAX marks the sequential, NCF, Item2Vec and multi-interest models' tables
with ``nn.with_partitioning(..., (('data', 'model'), None))``; the port
marks the same tables where it makes them (`parallel.mesh.shard_rows`).
This file holds:

* `param_partition_specs` against flax's partition metadata, name for name,
  for every model of the slice's seven files (JAX's side traced with
  `jax.eval_shape`, its names carried over by `interop.from_jax_params`);
* the vocabulary-parallel CE (`parallel.mesh.vocab_parallel_ce`) and its
  gradient against `full_softmax_loss` on the whole logits, at 1, 2 and 4
  shards simulated by threads over an in-process stand-in for the
  collectives (rtol 1e-6), and the sharded logits' refusal of any other
  use;
* SASRec, CORE, SRGNN, NeuMF and MIND taking three steps under JAX's
  sharded `Trainer` on conftest's virtual devices and under the port's four
  gloo ranks (`torch_parallel_workers.mesh_tables`, one spawn for every
  case), at meshes (2, 2), (1, 4) and (4, 1): the losses at rtol 1e-5; the
  tables, gathered whole, at 5r(b)'s Adam rule (`chip_smoke.py`: at most
  2e-5 of the entries outside rtol 1e-4 / atol 1e-6); the other
  parameters at the zoo's Adam rule (at most 1% of their entries beyond
  atol 2e-5 + rtol 1e-4, none beyond 6 lr: an entry whose gradient is
  rounding noise moves by up to lr a step in either package);
* TransRec, BERT4Rec, FDSA, NeuMF through `full_scores` and Item2Vec on a
  (2, 2) mesh against the port's unsharded run, by the same rules;
* SASRec's collective bytes a step at V and 2V (equal), a save and load of
  a sharded SASRec (`Trainer.save` / `load`, `OrbaxCheckpointer`) read
  back by `predict`, SASRec over a vocabulary the world does not divide
  (the last shard padded) against the port's unsharded run, and
  `run_sequential_experiment` / `run_matching_experiment` on a (2, 2) mesh
  against their unsharded runs;
* `chip_smoke.py` phase 5t(b) rehearsed at a small width.
"""

import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_item2vec as IV
import test_torch_matching_zoo as MZ
import test_torch_multi_interest as MI
import test_torch_pretrain as PT
import test_torch_sequential_zoo as Z
import torch_parallel_workers as W
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.matching import item2vec as jiv
from recbox_tpu.models.matching import multi_interest as jmi
from recbox_tpu.models.matching import neural_cf as jncf
from recbox_tpu.models.sequential import extended as jext
from recbox_tpu.models.sequential import models as jseq
from recbox_tpu.models.sequential import pretrain as jpre
from recbox_tpu.models.sequential import session_graph as jsg
from recbox_tpu.ops import full_softmax_loss as jfull_softmax_loss
from recbox_tpu.ops import get_matching_loss as jget_matching_loss
from recbox_tpu.parallel import make_mesh as jmake_mesh
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models import matching as pmatch
from recbox_tpu_torch.models import sequential as pseq
from recbox_tpu_torch.ops.losses import full_softmax_loss
from recbox_tpu_torch.parallel import mesh as M
from recbox_tpu_torch.parallel import param_partition_specs
from recbox_tpu_torch.training.trainer import is_embedding_table

MESHES = (2, 4, 1)             # n_model at 4 ranks: (2, 2), (1, 4), (4, 1)
# 5r(b)'s Adam rule for the tables, and the rest's tolerance
LOSS_RTOL, T_RTOL, T_ATOL, T_OUTSIDE = 1e-5, 1e-4, 1e-6, 2e-5
# the rest: Adam divides each entry's gradient by its own root mean
# square, so an entry whose gradient is rounding noise (an attention key's
# bias and CORE's alpha bias shift every logit of a softmax alike: their
# gradient is zero in exact arithmetic) moves by up to ~lr a step whatever
# the noise; at most 1% of the entries beyond atol 2e-5 + rtol 1e-4, none
# beyond 6 lr after three steps
P_RTOL, P_ATOL, LR = 1e-4, 2e-5, 1e-2


# -- the specs ------------------------------------------------------------------

def _seq_case(name):
    jm = Z._jmodel(name) if name != "SASRec" else jseq.SASRec(
        feature_map=Z._fm(JFeatureMap, JFeatureSpec), embedding_dim=Z.DIM,
        max_seq_len=Z.L, dropout=0.0, n_layers=1, n_heads=2)
    kw = Z._kw(name) if name != "SASRec" else dict(
        embedding_dim=Z.DIM, max_seq_len=Z.L, dropout=0.0, n_layers=1,
        n_heads=2)
    pm = getattr(pseq, name)(Z._fm(FeatureMap, FeatureSpec), device="cpu",
                             **kw)
    batch = {k: jnp.asarray(v) for k, v in Z._batch(0).items()}
    return [lambda k: jm.init(k, batch, method=jm.full_scores)], pm


def _pretrain_case(name):
    if name == "S3Rec":
        jm, pm = PT._s3rec_pair()
        probe = {k: jnp.asarray(v) for k, v in PT._probe().items()}
        return [lambda k: jm.init(k, probe, method=jm.pretrain_losses),
                lambda k: jm.init(k, {"item_seq": probe["masked_seq"],
                                      "seq_len": probe["seq_len"]},
                                  method=jm.full_scores)], pm
    kw = dict(embedding_dim=PT.DIM, max_seq_len=PT.L, hidden_size=12,
              n_layers=1, dropout=0.0, feature_vocab=PT.FV)
    jm = jpre.GRU4RecF(feature_map=PT._fm(JFeatureMap, JFeatureSpec), **kw)
    pm = pseq.GRU4RecF(PT._fm(FeatureMap, FeatureSpec), device="cpu", **kw)
    seq = np.ones((4, PT.L), np.int32)
    batch = {"item_seq": seq, "seq_len": np.full(4, PT.L, np.int32),
             "feat_seq": seq}
    return [lambda k: jm.init(k, batch, method=jm.full_scores)], pm


def _ncf_case(name):
    jfm, pfm = MZ._maps()
    kw, jextra = MZ._ncf_kwargs(name)
    common = dict(embedding_dim=MZ.DIM, num_users=MZ.N_USERS,
                  num_items=MZ.N_ITEMS)
    jm = getattr(jncf, name)(feature_map=jfm, **common, **kw, **jextra)
    pm = getattr(pmatch, name)(pfm, device="cpu", **common, **kw,
                               **{k: v.value for k, v in jextra.items()})
    jb = {k: jnp.asarray(v) for k, v in MZ._batch().items()}
    method = {"method": jm.all_scores_and_parts} if name == "ENMF" else {}
    return [lambda k: jm.init(k, jb, **method)], pm


def _mi_case(name):
    jfm, pfm = MI._maps()
    jb, _ = MI._batch(MI._data())
    kw = dict(MI.MODELS[name], embedding_dim=MI.DIM)
    jm = getattr(jmi, name)(feature_map=jfm, **kw)
    pm = getattr(pmatch, name)(pfm, device="cpu", **kw)
    return [lambda k: jm.init(k, jb)], pm


def _item2vec_case(name):
    jm = jiv.Item2Vec(num_items=IV.N_ITEMS, embedding_dim=IV.DIM)
    pm = pmatch.Item2Vec(IV.N_ITEMS, IV.DIM, device="cpu")
    return [lambda k: jm.init(k, IV._batch())], pm


SPEC_CASES = {
    **{n: _seq_case for n in ("SASRec", "GRU4Rec", "NARM", "STAMP", "Caser",
                              "NextItNet")},
    **{n: _seq_case for n in jext.__all__},
    "SRGNN": _seq_case, "GCSAN": _seq_case,
    "S3Rec": _pretrain_case, "GRU4RecF": _pretrain_case,
    **{n: _ncf_case for n in MZ.NCF},
    "Item2Vec": _item2vec_case,
    **{n: _mi_case for n in MI.MODELS},
}


def test_spec_cases_cover_the_slice():
    """Every model of the seven files has a case."""
    names = set(jseq.__all__) | set(jext.__all__) | set(jsg.__all__) \
        | set(jpre.__all__) | set(jncf.__all__) | {"Item2Vec"} \
        | set(jmi.__all__)
    names -= {"SequentialRecommender", "PairScoringModel", "enmf_loss",
              "session_adjacency", "sampled_softmax_inbatch_loss",
              "PRETRAIN_PARAMETERS", "masked_softmax"}
    assert names <= set(SPEC_CASES), names - set(SPEC_CASES)


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_param_partition_specs_match_flax(name):
    """{port name: spec} equals flax's metadata, flattened: each JAX leaf
    filled with 1 where its spec is (('data', 'model'), None), else 0, and
    carried to the port's names by `from_jax_params`."""
    inits, pm = SPEC_CASES[name](name)
    shapes = {}
    for init in inits:
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


# -- the vocabulary-parallel CE on simulated shards -----------------------------

class _Threads:
    """An in-process stand-in for a (1, n) mesh's collectives: each shard a
    thread, each collective a barrier."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)
        self.local = threading.local()

    def _exchange(self, x):
        r = self.local.rank
        self.slots[r] = x.detach().clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def all_reduce_(self, x, mesh=None, axis=None, op="sum"):
        if axis == M.DATA_AXIS:
            return x
        got = self._exchange(x)
        red = got[0]
        for g in got[1:]:
            red = torch.maximum(red, g) if op == "max" else red + g
        with torch.no_grad():
            x.copy_(red)
        return x

    def all_gather(self, x, mesh=None, axis=None, dim=0):
        if axis == M.DATA_AXIS:
            return x
        return torch.cat(self._exchange(x), dim=dim)

    def coords(self, mesh):
        return 0, self.local.rank


def _shard_runs(monkeypatch, n, z, targets, fn):
    """``fn(local logits, shard)`` on each of ``n`` shards of the columns
    of ``z`` (ragged: the last shard padded), in threads; their results."""
    world = _Threads(n)
    monkeypatch.setattr(M, "all_reduce_", world.all_reduce_)
    monkeypatch.setattr(M, "all_gather", world.all_gather)
    monkeypatch.setattr(M, "mesh_coords", world.coords)
    v = z.shape[1]
    s = -(-v // n)
    out, errors = [None] * n, []

    def run(r):
        world.local.rank = r
        try:
            local = torch.zeros(z.shape[0], s, dtype=z.dtype)
            lo = r * s
            valid = max(0, min(s, v - lo))
            local[:, :valid] = z[:, lo:lo + valid]
            out[r] = fn(local.requires_grad_(), M.RowShard(None, v, s, lo))
        except BaseException as e:      # re-raised in the test's thread
            errors.append(e)
            world.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
def test_vocab_parallel_ce_matches_full_softmax(monkeypatch, n):
    """The loss on every shard and the gradient on each shard's block
    against `full_softmax_loss` on the whole (B, V) logits (V = 37: the
    last shard padded), rtol 1e-6."""
    gen = torch.Generator().manual_seed(n)
    z = 3.0 * torch.randn(9, 37, generator=gen, dtype=torch.float64)
    targets = torch.randint(0, 37, (9,), generator=gen)
    targets[0] = 36                              # the last column
    whole = z.clone().requires_grad_()
    want = full_softmax_loss(whole, targets)
    want.backward()

    def one(local, shard):
        logits = M.ShardedLogits(local, shard, 37, 9)
        loss = full_softmax_loss(logits, targets)
        loss.backward()
        return loss.detach(), local.grad[:, :max(0, min(
            shard.shard_rows, 37 - shard.lo))]

    got = _shard_runs(monkeypatch, n, z, targets, one)
    for loss, _ in got:
        np.testing.assert_allclose(loss.numpy(), want.detach().numpy(),
                                   rtol=1e-6)
    grad = torch.cat([g for _, g in got], dim=1)
    np.testing.assert_allclose(grad.numpy(), whole.grad.numpy(), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_hit_positions_match_whole(monkeypatch, n):
    """The evaluators' ranks of the targets ('full', ties broken by the
    lower id, and over candidates) from sharded logits equal those of the
    whole logits."""
    from recbox_tpu_torch.quick_start import hit_positions
    gen = torch.Generator().manual_seed(10 + n)
    z = torch.randint(-3, 4, (8, 23), generator=gen).double()  # ties
    targets = torch.randint(0, 23, (8,), generator=gen)
    cand = torch.cat([targets[:, None], torch.randint(
        0, 23, (8, 5), generator=gen)], dim=1)
    for c in (None, cand):
        want = hit_positions(z, targets, c)
        got = _shard_runs(monkeypatch, n, z, targets, lambda local, shard:
                          hit_positions(M.ShardedLogits(
                              local.detach(), shard, 23, 8), targets, c))
        for g in got:
            assert torch.equal(g, want)


def test_sharded_logits_refuse_any_other_use():
    """A use that would read one rank's columns as the whole row raises."""
    logits = M.ShardedLogits(torch.zeros(4, 3), M.RowShard(None, 9, 3, 3), 9,
                             4)
    uses = [lambda x: x.max(), lambda x: torch.max(x), lambda x: x + 1,
            lambda x: x[0], lambda x: float(x), lambda x: np.asarray(x),
            lambda x: torch.log_softmax(x, -1), lambda x: x.float(),
            lambda x: len(x), lambda x: x.shape, lambda x: x.device]
    for use in uses:
        with pytest.raises(TypeError):
            use(logits)
    with pytest.raises(TypeError):
        (lambda out, b: out.max())(logits, None)    # a user's loss


# -- four gloo ranks against JAX's sharded trainer ------------------------------

def _jmodel(name, v=W.MT_V):
    fm = W.mt_feature_map(JFeatureMap, JFeatureSpec, v)
    mod = {"SASRec": jseq, "CORE": jext, "SRGNN": jsg, "NeuMF": jncf,
           "MIND": jmi}[name]
    return getattr(mod, name)(feature_map=fm, **W.mt_kwargs(name, v))


def _jtrainer(name, mesh):
    method = W.MT_CASES[name][2]
    if method == "full_scores":
        def loss(o, b):
            return jfull_softmax_loss(o, b["item_id"])
    else:
        match = jget_matching_loss("SoftmaxCrossEntropyLoss")

        def loss(o, b):
            return match(o)
    return JTrainer(_jmodel(name), loss,
                    JTrainerConfig(learning_rate=LR, epochs=1,
                                   monitor="AUC", seed=5),
                    mesh=mesh, train_method=method)


def _port_params(tree, name):
    state = from_jax_params(Z._np_tree(tree), W.mt_model(name))
    return {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded runs of every case and mesh from its initial state
    (seed 5), the port's four ranks from the same state, and the port's
    unsharded runs in this process."""
    tmp = tmp_path_factory.mktemp("mesh_tables")
    batch = W.mt_batch()
    np.savez(tmp / "batch.npz", **batch)
    states, expect, plain = {}, {}, {}
    for name in W.MT_CASES:
        jt = _jtrainer(name, None)
        jt.init(batch)
        states[name] = str(tmp / f"{name}.pt")
        torch.save({k: torch.from_numpy(v) for k, v in _port_params(
            jt.params, name).items()}, states[name])
    for i, name in enumerate(W.MT_PORT):
        torch.manual_seed(20 + i)
        states[name] = str(tmp / f"{name}.pt")
        torch.save(W.mt_model(name).state_dict(), states[name])
    torch.manual_seed(6)
    ragged_state = str(tmp / "ragged.pt")
    torch.save(W.mt_model("SASRec", v=50).state_dict(), ragged_state)
    # the four ranks run beside JAX's compiles
    port = []
    ranks = threading.Thread(target=lambda: port.extend(W.run(
        "mesh_tables", 4, tmp, states=states,
        batch_path=str(tmp / "batch.npz"), meshes=list(MESHES),
        ragged_state=ragged_state, ckpt_dir=str(tmp))))
    ranks.start()
    try:
        for name in list(W.MT_CASES) + list(W.MT_PORT):
            t, losses = W.mt_steps(name, states[name], batch, None)
            plain[name] = (losses, {k: v.detach().numpy().copy()
                                    for k, v in t.params.items()})
            if name in W.MT_PORT:
                continue
            for m in MESHES:
                jt = _jtrainer(name, jmake_mesh(num_model_shards=m,
                                                devices=jax.devices()[:4]))
                jt.init(batch)
                losses = [float(jt.train_step(dict(batch)))
                          for _ in range(3)]
                expect[name, m] = (losses, _port_params(jt.params, name))
        _, ragged_losses = W.mt_steps("SASRec", ragged_state,
                                      W.mt_batch(seed=5, v=50), None, v=50)
        pipelines = W.mt_pipelines()
    finally:
        ranks.join()
    assert len(port) == 4, "a rank failed"
    return expect, plain, port, ragged_losses, pipelines


def _outside_share(got, want):
    bad = np.abs(got - want) > T_ATOL + T_RTOL * np.abs(want)
    return bad.mean()


@pytest.mark.parametrize("name", list(W.MT_CASES))
@pytest.mark.parametrize("m", MESHES)
def test_sharded_steps_match_jax(runs, name, m):
    """The port's four ranks against JAX's sharded trainer of the same mesh
    shape, after three steps of one global batch."""
    expect, port = runs[0], runs[2]
    _check_steps(port, name, m, *expect[name, m])


@pytest.mark.parametrize("name", list(W.MT_PORT))
def test_more_sharded_routes_match_unsharded(runs, name):
    """TransRec's replicated bias beside its sharded table, BERT4Rec's
    [MASK] row outside the scored columns, FDSA's feature table, NeuMF
    trained through `full_scores` (its tables gathered whole) and Item2Vec
    on a (2, 2) mesh, against the port's unsharded run from one state, by
    the same rules."""
    plain, port = runs[1], runs[2]
    _check_steps(port, name, 2, *plain[name])


def _check_steps(port, name, m, losses, params):
    for r in range(4):
        np.testing.assert_allclose(port[r][f"{name}/m{m}/loss"], losses,
                                   rtol=LOSS_RTOL)
    got = port[0]
    tables = [k for k in params if is_embedding_table(k)]
    assert tables
    outside, entries = 0, 0
    for k, want in params.items():
        mine = got[f"{name}/m{m}/{k}"]
        assert mine.shape == want.shape, k
        if k in tables:
            assert _outside_share(mine, want) <= T_OUTSIDE, (k, np.abs(
                mine - want).max())
            continue
        # the zoo's Adam rule (`test_torch_sequential_zoo`), three steps
        diff = np.abs(mine - want)
        assert diff.max() <= 6 * LR, k
        outside += int((diff > P_ATOL + P_RTOL * np.abs(want)).sum())
        entries += want.size
    assert outside <= 0.01 * entries, (outside, entries)
    for r in range(1, 4):                   # every rank gathers alike
        for k in params:
            np.testing.assert_array_equal(port[r][f"{name}/m{m}/{k}"],
                                          got[f"{name}/m{m}/{k}"])


@pytest.mark.parametrize("name", list(W.MT_CASES))
def test_each_rank_holds_its_rows(runs, name):
    """Under every mesh shape each sharded table keeps ceil(V / 4) rows on
    a rank; the unsharded run's tables are whole."""
    plain, port = runs[1], runs[2]
    sharded = {k for k in port[0] if k.startswith(f"{name}/m2/local/")}
    assert sharded
    for key in sharded:
        pname = key.split("/local/")[1]
        rows = plain[name][1][pname].shape[0]
        for m in MESHES:
            for r in range(4):
                shape = port[r][f"{name}/m{m}/local/{pname}"]
                assert shape[0] == -(-rows // 4), (pname, shape)


def test_collective_bytes_do_not_grow_with_the_vocabulary(runs):
    """SASRec on a (2, 2) mesh: the same collectives and bytes a step at
    V and 2V."""
    port = runs[2]
    for r in range(4):
        v, v2 = port[r][f"bytes/v{W.MT_V}"], port[r][f"bytes/v{2 * W.MT_V}"]
        assert int(v) > 0
        assert int(v) == int(v2)
        assert list(port[r][f"kinds/v{W.MT_V}"]) \
            == list(port[r][f"kinds/v{2 * W.MT_V}"])


def test_save_and_load_reproduce_predict(runs):
    port = runs[2]
    for r in range(4):
        np.testing.assert_array_equal(port[r]["predict/loaded"],
                                      port[r]["predict/trained"])
        assert port[r]["predict/trained"].shape == (W.MT_B, 1 + W.MT_NEGS)


def test_orbax_checkpoint_reproduces_predict(runs):
    port = runs[2]
    for r in range(4):
        np.testing.assert_array_equal(port[r]["predict/orbax"],
                                      port[r]["predict/trained"])


@pytest.mark.parametrize("pipeline", ["sequential", "matching"])
def test_pipelines_on_a_mesh_match_unsharded(runs, pipeline):
    """`run_sequential_experiment(mesh=)` and `run_matching_experiment(
    mesh=)` (SASRec, full-softmax CE, 2 epochs, best-valid weights) on a
    (2, 2) mesh give the unsharded run's metrics (1e-6)."""
    port, plain = runs[2], runs[4][pipeline]
    keys = sorted(k.split("/", 2)[2] for k in port[0]
                  if k.startswith(f"pipeline/{pipeline}/"))
    assert keys == sorted(plain)
    for r in range(4):
        for k in keys:
            np.testing.assert_allclose(
                port[r][f"pipeline/{pipeline}/{k}"], plain[k], atol=1e-6,
                err_msg=k)


def test_ragged_vocabulary_matches_unsharded(runs):
    """V = 50 over four ranks (13 rows a shard, the last padded by 2)."""
    port, ragged = runs[2], runs[3]
    for r in range(4):
        np.testing.assert_allclose(port[r]["ragged/loss"], ragged,
                                   rtol=LOSS_RTOL)


def test_chip_smoke_5t_two_rank_rehearsal(monkeypatch):
    """`chip_smoke.py` phase 5t(b) on the CPU at a small width: the two
    gloo ranks (`t_gloo_rank`), SASRec's rows a rank and bytes held, its
    losses, table and recorded bytes against the unsharded run and the
    model, the full sort and MIND's served ids against the unsharded
    evaluation and service, and the phase's own check (the plain versions
    count no launches)."""
    import importlib
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    cs = importlib.import_module("chip_smoke")
    width = dict(SAS_V=2000, T_GLOO_BATCH=64, T_EVAL_USERS=300,
                 T_EVAL_BATCH=512, T_MI_QUERIES=16, T_MI_K=20)
    for k, v in width.items():
        monkeypatch.setattr(cs, k, v)
    res = cs.mesh_tables_two_ranks(device="cpu", width=width)
    assert cs.check_mesh_tables(res, on_card=False)
    s0 = res["ranks"][0]["sasrec"]
    assert s0["counted_bytes"] == s0["model_bytes"]["total"]
    assert s0["table_bytes_held_unsharded"] == 2000 * 64 * 4 * 3
    assert s0["eval_ids_bit_equal"] and s0["eval_metrics_equal"]
