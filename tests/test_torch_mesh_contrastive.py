"""The contrastive terms that span the global batch, under a mesh, against
JAX's sharded `Trainer`.

Under JAX's sharded step a loss function sees the global batch: YoutubeSBC's
in-batch scores and MCCLK's in-batch InfoNCE take every rank's items as
negatives, and SGL's and NCL's InfoNCE sums run over every rank's rows. The
port's ranks see their own rows, so the models read the mesh they were
sharded over (`parallel.mesh.module_mesh`): YoutubeSBC scores this rank's
users against the global batch's items (`inbatch_columns`, their gradient
summed over 'data') and `sampled_softmax_inbatch_loss` finds each row's
positive at this rank's offset and gathers the global batch's ``log_q``;
MCCLK gathers the positives' ids and reads their rows from its whole views;
SGL's ``ssl_loss`` and NCL's ``structural_loss`` weigh their sums by
n_data, which the trainer's mean over 'data' divides out.

Each case takes three steps of one global batch under JAX's sharded trainer
on conftest's virtual devices and under the port's four gloo ranks
(`torch_parallel_workers.mesh_contrastive`, one spawn), at meshes (2, 2),
(1, 4) and (4, 1), with JAX's own loss functions: YoutubeSBC's
``sampled_softmax_inbatch_loss(o, log_q[b["item_id"]])``, and BPR plus the
model's term for the others (SGL on two fixed edge keep-masks, NCL on
prototypes drawn once from the initial tables). Held by
`test_torch_mesh_graph`'s rules (`check_steps`).
"""

import itertools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh_graph as MG
import torch_parallel_workers as W
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models import knowledge as jknow
from recbox_tpu.models.knowledge import intent as jintent
from recbox_tpu.models.matching import graph_extended as jgext
from recbox_tpu.models.matching import multi_interest as jmi
from recbox_tpu.ops import get_matching_loss as jget_matching_loss
from recbox_tpu.parallel import make_mesh as jmake_mesh
from recbox_tpu.parallel.mesh import shard_params as jshard_params
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu_torch.interop import from_jax_params

MESHES = MG.MESHES
# NCL's prototypes, set before JAX's steps are traced
_PROTOS = {}


class JSGL(jgext.SGL):
    def scores_and_term(self, batch, train: bool = False):
        return self(batch, train=train), self.ssl_loss(batch)


class JNCL(jgext.NCL):
    def scores_and_term(self, batch, train: bool = False):
        protos = [jnp.asarray(p) for p in _PROTOS["NCL-even"]]
        return self(batch, train=train), \
            self.structural_loss(batch) + self.prototype_loss(batch, *protos)


class JMCCLK(jintent.MCCLK):
    def scores_and_term(self, batch, train: bool = False):
        return self(batch, train=train), self.contrastive_loss(batch)


JCLS = {"SGL-even": JSGL, "NCL-even": JNCL, "MCCLK-even": JMCCLK}


def jmodel(case):
    if case == "YoutubeSBC":
        return jmi.YoutubeSBC(
            feature_map=W.mc_feature_map(JFeatureMap, JFeatureSpec),
            embedding_dim=W.MG_D, user_hidden_units=W.MC_HIDDEN,
            item_hidden_units=W.MC_HIDDEN)
    cls = case.split("-")[0]
    size = W.mg_size(case)
    graph = W.mg_case_graph(case)
    if cls in W.MG_GRAPH:
        graph = {k: (tuple(v.tolist()) if isinstance(v, np.ndarray) else v)
                 for k, v in graph.items()}
    else:
        graph = {k: (jknow.StaticArray(v) if isinstance(v, np.ndarray)
                     else v) for k, v in graph.items()}
    fm = W.mg_feature_map(JFeatureMap, JFeatureSpec, size["users"],
                          size["items"])
    return JCLS[case](feature_map=fm, embedding_dim=W.MG_D,
                      **W.MG_KW[cls], **graph)


def jtrainer(case, mesh):
    if case == "YoutubeSBC":
        log_q = jnp.asarray(W.mc_log_q())

        def loss(o, b):
            return jmi.sampled_softmax_inbatch_loss(o, log_q[b["item_id"]])
        method = "inbatch_scores"
    else:
        bpr = jget_matching_loss("PairwiseLogisticLoss")

        def loss(o, b):
            return bpr(o[0]) + o[1]
        method = "scores_and_term"
    return JTrainer(jmodel(case), loss, JTrainerConfig(**W.mc_config(case)),
                    mesh=mesh, train_method=method)


def _initial(case, batch):
    """JAX's initial parameters, every all-zero leaf (YoutubeSBC's dense
    biases) drawn from normal(0, 0.1), as `test_torch_mesh_graph` does."""
    jt = jtrainer(case, None)
    jt.init(batch)
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(a.dtype)
        if not a.any() else a, MG._np(jt.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded runs of every case at every mesh, from its initial
    state; the port's four ranks from the same states."""
    tmp = tmp_path_factory.mktemp("mesh_contrastive")
    states, initial, expect = {}, {}, {}
    # placeholders of the prototypes' shapes for JAX's init
    size = W.mg_size("NCL-even")
    _PROTOS["NCL-even"] = (np.zeros((3, W.MG_D), np.float32),
                           np.zeros((3, W.MG_D), np.float32),
                           np.zeros(size["users"], np.int64),
                           np.zeros(size["items"], np.int64))
    for case in W.MC_CASES:
        batch = W.mc_batch(case)
        np.savez(tmp / f"{case}.npz", **batch)
        initial[case] = _initial(case, batch)
        states[case] = str(tmp / f"{case}.pt")
        torch.save(from_jax_params(initial[case], W.mc_model(case)),
                   states[case])
    # NCL's prototypes from its initial tables (k-means on the host)
    ncl = W.mc_model("NCL-even", states["NCL-even"])
    _PROTOS["NCL-even"] = ncl.prototypes(3, n_iters=5)
    np.savez(tmp / "protos.npz", **{f"p{i}": np.asarray(p) for i, p in
                                    enumerate(_PROTOS["NCL-even"])})
    port = []
    ranks = threading.Thread(target=lambda: port.extend(W.run(
        "mesh_contrastive", 4, tmp, states=states, batch_dir=str(tmp),
        meshes=list(MESHES), protos_path=str(tmp / "protos.npz"))))
    ranks.start()
    masks = itertools.cycle([jnp.asarray(m > 0) for m in W.sgl_masks(
        len(W.mg_case_graph("SGL-even")["edge_users"]))])
    try:
        with pytest.MonkeyPatch.context() as mp:
            # SGL's two dropout views on the port's fixed keep-masks
            mp.setattr(jax.random, "bernoulli",
                       lambda key, p, shape: next(masks))
            for case in W.MC_CASES:
                batch = W.mc_batch(case)
                for m in MESHES:
                    mesh = jmake_mesh(num_model_shards=m,
                                      devices=jax.devices()[:4])
                    jt = jtrainer(case, mesh)
                    jt.init(batch)
                    jt.params = jshard_params(jax.tree_util.tree_map(
                        jnp.asarray, initial[case]), mesh, jt.param_specs)
                    jt.opt_state = jt.tx.init(jt.params)
                    losses = [float(jt.train_step(dict(batch)))
                              for _ in range(3)]
                    expect[case, m] = (losses, {
                        k: v.numpy() for k, v in from_jax_params(
                            MG._np(jt.params), W.mc_model(case)).items()})
    finally:
        ranks.join()
    assert len(port) == 4, "a rank failed"
    return expect, port


@pytest.mark.parametrize("case", W.MC_CASES)
@pytest.mark.parametrize("m", MESHES)
def test_contrastive_steps_match_jax(runs, case, m):
    """The port's four ranks against JAX's sharded trainer of the same mesh
    shape, after three steps of one global batch under JAX's loss
    function: every rank's losses at rtol 1e-5, the tables at 5r(b)'s Adam
    rule, the other parameters at the zoo's."""
    expect, port = runs
    MG.check_steps(port, case, m, *expect[case, m])

