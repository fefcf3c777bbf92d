"""The cloze and MIP heads under a mesh, against JAX's sharded logits.

In JAX, BERT4Rec's ``masked_item_scores`` and S3Rec's ``mip_logits`` are
einsums of the masked positions' states against the row-sharded item
table; GSPMD splits them along V. The port returns the same scores as
`parallel.mesh.ShardedLogits` of the B·P positions (the global batch's rows
against this rank's columns; [MASK] and the padding take no part), which
`vocab_parallel_ce` (with the positions' weights, as `fused_softmax_ce`
takes them) and `sharded_hit_positions` read. `fused_cloze_loss` and
SASRec's `fused_ce_loss` (and the trainer's ``train_method=
'fused_ce_loss'``) stay single-shard paths and raise under a mesh, as
JAX's flash-CE and trainer do.

At meshes (2, 2), (1, 4) and (4, 1), from one state, the port's four gloo
ranks (`torch_parallel_workers.mesh_cloze`, one spawn) against JAX's
parameters sharded on conftest's virtual devices: the weighted cloze CE
(sum(w·ce) / sum(w), a pad position at weight 0) and the unweighted one
at rtol 1e-5, the gradient of JAX's objective at rtol 1e-4 / atol 1e-7 of
the largest entry, each rank's hit positions equal.
"""

import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.sequential import extended as jext
from recbox_tpu.models.sequential import pretrain as jpre
from recbox_tpu.parallel import make_mesh as jmake_mesh
from recbox_tpu.parallel.mesh import param_partition_specs as jspecs
from recbox_tpu.parallel.mesh import shard_params as jshard_params
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.parallel import mesh as M

MESHES = (2, 4, 1)            # n_model at 4 ranks: (2, 2), (1, 4), (4, 1)
LOSS_RTOL, G_RTOL, G_ATOL = 1e-5, 1e-4, 1e-7


def jmodel(case):
    cls = jext.BERT4Rec if case == "BERT4Rec" else jpre.S3Rec
    return cls(feature_map=W.cz_feature_map(JFeatureMap, JFeatureSpec),
               embedding_dim=W.MT_D, max_seq_len=W.MT_L, n_layers=1,
               n_heads=2, dropout=0.0)


def jhead(jm, case):
    return jm.masked_item_scores if case == "BERT4Rec" else jm.mip_logits


def _jax_case(case, batch):
    """(initial params (boxed), the head's logits, the loss and gradient
    functions of the weighted and unweighted CE) of JAX's model."""
    jm = jmodel(case)
    args = [jnp.asarray(batch[k]) for k in ("item_seq", "seq_len",
                                             "positions")]
    key = jax.random.PRNGKey(7)
    boxed = jm.init(key, *args, method=jhead(jm, case))["params"]
    if case == "S3Rec":
        # the fine-tune and SP trees too: every parameter the port has
        seq = args[:2]
        boxed = {**jm.init(key, {"item_seq": seq[0], "seq_len": seq[1]},
                           method=jm.full_scores)["params"],
                 **jm.init(key, *seq, *seq, *seq,
                           method=jm.sp_logits)["params"], **boxed}

    def logits(p):
        return jm.apply({"params": p}, *args, method=jhead(jm, case))

    def ce(p, w):
        logp = jax.nn.log_softmax(logits(p), axis=-1)
        picked = jnp.take_along_axis(
            logp, jnp.asarray(batch["labels"])[..., None], axis=2)[..., 0]
        return -jnp.sum(w * picked) / jnp.sum(w)
    return boxed, jax.jit(logits), jax.jit(jax.value_and_grad(ce))


def _positions(z, labels):
    """`hit_positions`' 'full' count of each row of (R, V) scores."""
    t = np.take_along_axis(z, labels[:, None], axis=1)
    cols = np.arange(z.shape[1])[None, :]
    return np.sum((z > t) | ((z == t) & (cols < labels[:, None])), axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cloze")
    batch = W.cz_batch()
    np.savez(tmp / "batch.npz", **batch)
    states, jcases = {}, {}
    for case in W.CZ_CASES:
        jcases[case] = _jax_case(case, batch)
        states[case] = str(tmp / f"{case}.pt")
        torch.save(from_jax_params(fnn.meta.unbox(jcases[case][0]),
                                   W.cz_model(case)), states[case])
    port = []
    ranks = threading.Thread(target=lambda: port.extend(W.run(
        "mesh_cloze", 4, tmp, states=states,
        batch_path=str(tmp / "batch.npz"), meshes=list(MESHES))))
    ranks.start()
    expect = {}
    try:
        w = jnp.asarray(batch["weights"])
        for case in W.CZ_CASES:
            boxed, logits, vg = jcases[case]
            for m in MESHES:
                mesh = jmake_mesh(num_model_shards=m,
                                  devices=jax.devices()[:4])
                p = jshard_params(fnn.meta.unbox(boxed), mesh, jspecs(boxed))
                loss, grads = vg(p, w)
                plain, _ = vg(p, jnp.ones_like(w))
                z = np.asarray(logits(p)).reshape(-1, W.CZ_V)
                expect[case, m] = (
                    float(loss), float(plain),
                    {k: v.numpy() for k, v in from_jax_params(
                        jax.tree_util.tree_map(np.asarray, grads),
                        W.cz_model(case)).items()},
                    _positions(z, batch["labels"].reshape(-1)))
    finally:
        ranks.join()
    assert len(port) == 4, "a rank failed"
    return expect, port


@pytest.mark.parametrize("case", W.CZ_CASES)
@pytest.mark.parametrize("m", MESHES)
def test_sharded_heads_match_jax(runs, case, m):
    """Each rank's weighted and unweighted CE (the world's mean of the
    ranks' values) against JAX's on its sharded logits, the gradient of
    JAX's objective gathered whole on every rank, and each rank's hit
    positions against JAX's logits' rows of this rank."""
    expect, port = runs
    loss, plain, grads, hits = expect[case, m]
    for r in range(4):
        got = port[r]
        np.testing.assert_allclose(got[f"{case}/m{m}/loss"][0], loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[f"{case}/m{m}/unweighted"][0], plain,
                                   rtol=LOSS_RTOL)
        top = max(float(np.abs(g).max()) for g in grads.values())
        for k, want in grads.items():
            np.testing.assert_allclose(got[f"{case}/m{m}/grad/{k}"], want,
                                       rtol=G_RTOL, atol=G_ATOL * top,
                                       err_msg=k)
        lo = int(got[f"{case}/m{m}/rows"])
        mine = got[f"{case}/m{m}/hits"]
        np.testing.assert_array_equal(mine, hits[lo:lo + len(mine)])


def test_fused_cloze_loss_still_refuses_a_mesh(tmp_path):
    """BERT4Rec's flash-CE cloze loss is a single-shard op under a mesh, as
    JAX's flash-CE: on a world of one rank of a sharded table (the table's
    shard marked as the mesh leaves it) it raises, naming the reason."""
    model = W.cz_model("BERT4Rec")
    shard = M.RowShard(None, model.emb_item.shape[0],
                       model.emb_item.shape[0], 0)
    model._shard = lambda: shard
    b = {k: torch.from_numpy(v) for k, v in W.cz_batch().items()}
    with pytest.raises(NotImplementedError, match="single-shard op"):
        model.fused_cloze_loss(b["item_seq"], b["seq_len"], b["positions"],
                               b["labels"], b["weights"])


def test_fused_ce_loss_still_refuses_a_mesh():
    """SASRec's flash-CE next-item loss and the trainer's
    ``train_method='fused_ce_loss'`` refuse a mesh, as JAX's trainer
    refuses it (`recbox_tpu/training/trainer.py:133-143`)."""
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.sequential import SASRec
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    model = SASRec(W.cz_feature_map(FeatureMap, FeatureSpec),
                   embedding_dim=W.MT_D, max_seq_len=W.MT_L, n_layers=1,
                   n_heads=2, dropout=0.0, device="cpu")
    rows = model.emb_item.shape[0]
    shard = M.RowShard(None, rows, rows, 0)
    model._shard = lambda: shard
    b = {k: torch.from_numpy(v) for k, v in W.cz_batch().items()}
    b["item_id"] = b["labels"][:, 0]
    with pytest.raises(ValueError, match="single-shard"):
        model.fused_ce_loss(b)
    with pytest.raises(ValueError, match="single-shard"):
        Trainer(model, lambda o, b: o, TrainerConfig(), mesh=object(),
                device="cpu", train_method="fused_ce_loss")
