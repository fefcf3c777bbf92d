"""The knowledge models' own tables row-sharded under a mesh, against the
JAX package (the graph models and the shared helpers:
`test_torch_mesh_graph.py`).

* KSR's history on a row-sharded item table, on a ('data') mesh of two gloo
  ranks (`torch_parallel_workers.ksr_history`), against the unsharded KSR
  from the same weights, every history holding an id past the middle of
  the vocabulary: the user tower, the training scores and the full-softmax
  CE of each rank's rows (rtol 1e-6, atol 1e-9);
* KGAT, KGIN, CKE, RippleNet and KSR taking three steps under JAX's sharded
  `Trainer` on conftest's virtual devices and under the port's four gloo
  ranks (one spawn for the file's cases), at meshes (2, 2), (1, 4) and
  (4, 1), and the same runs against the port's unsharded run, by
  `test_torch_mesh_tables`' rules (`test_torch_mesh_graph.check_steps`);
* KGCN, KGNNLS (with its label smoothness), CFKG, KTUP, MKR, MCCLK and
  KGAT over a node table the world does not divide on a (2, 2) mesh
  against the port's unsharded run from one state, by the same rules;
* KGCN's, KTUP's and RippleNet's ``full_scores`` on a (2, 2) mesh (their
  tables gathered whole inside `parallel.mesh.whole_tables`) against the
  unsharded model's (rtol 1e-6, atol 1e-9);
* each sharded table's rows a rank, KGAT's 65-row node table over four
  ranks (17 a shard, the last padded by 3 rows that stay zero), and
  `run_kg_experiment` over KGAT and CKE on a (2, 2) mesh against its
  unsharded run (their KG phase included: the drawn KG batch counts
  once; atol 1e-6).
"""

import numpy as np
import pytest
import torch

import test_torch_mesh_graph as G
import torch_parallel_workers as W
from recbox_tpu_torch.ops.losses import full_softmax_loss

KSR_RTOL, KSR_ATOL = 1e-6, 1e-9


# -- KSR's history on a sharded table -------------------------------------------

@pytest.fixture(scope="module")
def ksr(tmp_path_factory):
    """Two gloo ranks' KSR outputs and the unsharded KSR's on the whole
    batch, from one state."""
    tmp = tmp_path_factory.mktemp("ksr_history")
    torch.manual_seed(31)
    state = str(tmp / "ksr.pt")
    torch.save(W.mg_model("KSR").state_dict(), state)
    batch = W.mg_batch("KSR", seed=7)
    items = W.mg_size("KSR")["items"]
    batch["cand"] = np.random.default_rng(8).integers(
        1, items, (W.MG_B, 1 + W.MG_NEGS)).astype(np.int32)
    np.savez(tmp / "batch.npz", **batch)
    assert (batch["item_seq"] > items // 2).any(axis=1).all()
    ranks = W.run("ksr_history", 2, tmp, state_path=state,
                  batch_path=str(tmp / "batch.npz"))
    model = W.mg_model("KSR", state).eval()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    n = W.MG_B // 2
    with torch.no_grad():
        user = model.user_tower(tb)
        scores = model(dict(tb, **{"__item_ids__": tb["cand"],
                                   "item::item_id": tb["cand"]}))
        logits = model.full_scores(tb)
        ce = [float(full_softmax_loss(logits[r * n:(r + 1) * n],
                                      tb["item_id"][r * n:(r + 1) * n]))
              for r in range(2)]
    return ranks, {"user": user.numpy(), "scores": scores.numpy(),
                   "ce": np.asarray(ce)}


@pytest.mark.parametrize("out", ["user", "scores", "ce"])
def test_ksr_history_reads_a_sharded_item_table(ksr, out):
    """Each rank holds 16 of the 32 item rows and its outputs equal the
    unsharded KSR's on its rows: the history comes through the mesh's
    exchange, not from the local shard by global id."""
    ranks, plain = ksr
    n = W.MG_B // 2
    for r in range(2):
        assert int(ranks[r]["rows"]) == W.mg_size("KSR")["items"] // 2
        want = plain[out][r] if out == "ce" else plain[out][r * n:(r + 1) * n]
        np.testing.assert_allclose(ranks[r][out], want, rtol=KSR_RTOL,
                                   atol=KSR_ATOL)


# -- four gloo ranks against JAX's sharded trainer ------------------------------

JAX_CASES = tuple(c for c in W.MG_JAX if c not in W.MG_GRAPH)
PORT_CASES = tuple(c for c in W.MG_PORT if c not in W.MG_GRAPH)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return G.mesh_runs(tmp_path_factory.mktemp("mesh_knowledge"), JAX_CASES,
                       PORT_CASES, pipelines=("KGAT", "CKE"))


@pytest.mark.parametrize("name", JAX_CASES)
@pytest.mark.parametrize("m", G.MESHES)
def test_sharded_steps_match_jax(runs, name, m):
    """The port's four ranks against JAX's sharded trainer of the same mesh
    shape, after three steps of one global batch."""
    G.check_steps(runs[2], name, m, *runs[0][name, m])


@pytest.mark.parametrize("name", JAX_CASES)
@pytest.mark.parametrize("m", G.MESHES)
def test_sharded_steps_match_unsharded(runs, name, m):
    """The same ranks against the port's unsharded run from the same
    state."""
    G.check_steps(runs[2], name, m, *runs[1][name])


@pytest.mark.parametrize("name", PORT_CASES)
def test_more_sharded_routes_match_unsharded(runs, name):
    """The other knowledge models on a (2, 2) mesh against the port's
    unsharded run from one state."""
    G.check_steps(runs[2], name, 2, *runs[1][name])


@pytest.mark.parametrize("name", JAX_CASES + PORT_CASES)
def test_each_rank_holds_its_rows(runs, name):
    G.check_rows(runs, name)


def test_ragged_node_table(runs):
    """KGAT's node table, 41 entities + 24 users = 65 rows, over four
    ranks of a (2, 2) mesh: 17 rows a shard, the last holding 14 real rows
    and 3 padding rows that stay zero through the steps (no hop reads
    them); its steps match the unsharded run's (above)."""
    port = runs[2]
    shapes = [tuple(port[r]["KGAT-ragged/m2/local/emb_node"])
              for r in range(4)]
    assert shapes == [(17, W.MG_D, 17)] * 3 + [(17, W.MG_D, 14)], shapes
    assert float(port[3]["KGAT-ragged/m2/padding/emb_node"]) == 0.0
    assert port[0]["KGAT-ragged/m2/emb_node"].shape == (65, W.MG_D)


@pytest.mark.parametrize("name", W.MG_FULL_SCORES)
def test_pair_scorers_full_scores_read_whole_tables(runs, name):
    """KGCN's, KTUP's and RippleNet's ``full_scores`` (every item for each
    user, f(u, i) over the tables gathered whole inside
    `parallel.mesh.whole_tables`) of each rank's rows on a (2, 2) mesh,
    from the saved state, against the unsharded model's (rtol 1e-6, atol
    1e-9)."""
    port = runs[2]
    state = str(runs[4] / f"{name}.pt")
    batch = W.mg_batch(name)
    model = W.mg_model(name, state).eval()
    with torch.no_grad():
        want = model.full_scores({k: torch.from_numpy(v)
                                  for k, v in batch.items()}).numpy()
    n = W.MG_B // 2                       # a 'data' shard of (2, 2)
    for r in range(4):
        d = r // 2
        np.testing.assert_allclose(port[r][f"{name}/full_scores"],
                                   want[d * n:(d + 1) * n], rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("pipeline", ["KGAT", "CKE"])
def test_kg_pipeline_on_a_mesh_matches_unsharded(runs, pipeline):
    """`run_kg_experiment(mesh=)` (2 epochs, each a CF phase and 3 KG
    steps on batches of 16 triples, evaluations in batches of 16) on a
    (2, 2) mesh gives the unsharded run's metrics (atol 1e-6)."""
    G.check_pipeline(runs, pipeline)
