"""`SparseEmbeddingTrainer` of the port against the JAX package's, on the CPU.

Three steps from the same transplanted params on the same batches, with
ids that repeat inside a batch, a table shared by two features, the
touched-row `embedding_regularizer`, and a plateau between the second and
the third step (the dense lr and the embedding lr a tenth): the losses
(rtol 1e-6), the tables (rtol 1e-6, atol 1e-6 of the table's largest
entry: an entry that sums AdaGrad steps of ~emb_lr of opposite sign lands
near 0 with the steps' rounding), the accumulators (rtol 1e-6) and the
dense parameters (rtol 1e-5, atol 1e-5 of the tensor's largest entry:
Adam's steps of ~lr over gradients summed in another order) against
JAX's.

- MF on `MatchingLoader` batches. JAX's trainer hands rows only to the
  top-level features, which MF's item tower does not read; its side runs
  a test-local MF whose item tower reads the candidates' rows, fed the
  candidate ids as its ``item_id`` column: the rows the port routes from
  the ``item::`` columns.
- DeepFM (dense MLP and first-order parameters under Adam).

Also on the port alone: `save` / `load` round trips bit for bit, and
`train_steps_fused` on the CPU equals K `train_step` calls bit for bit;
a duplicated id takes its scale from the accumulator after all of the
batch's g² (not a per-occurrence update in order).
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.base import similarity_scores as jsimilarity
from recbox_tpu.models.matching import two_tower as jtt
from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
from recbox_tpu.nn.embedding import rows_key_for as jrows_key_for
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.ops import get_matching_loss as jget_matching_loss
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.sparse import (
    SparseEmbeddingTrainer as JSparseTrainer,
)
from recbox_tpu_torch.data import ArrayLoader, MatchingLoader
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.matching import MF
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.ops.losses import binary_crossentropy, get_matching_loss
from recbox_tpu_torch.training import SparseEmbeddingTrainer, TrainerConfig

N_USERS, N_ITEMS, DIM, B = 12, 15, 8, 16
CFG = dict(learning_rate=5e-2, embedding_regularizer=0.05, seed=3)


class _JRowsMF(jtt.MF):
    """JAX MF whose item tower reads the rows of its ``item_id`` column
    ((B, S) candidate ids) from the batch."""

    def __call__(self, batch, train=False):
        user_emb = self.user_tower(batch, train)
        rk = jrows_key_for(("item_embedding",), "item_id")
        item_emb = self.item_tower({k: batch[k] for k in ("item_id", rk)
                                    if k in batch}, train)
        s = batch["__item_ids__"].shape[1]
        return jsimilarity(user_emb, item_emb.reshape(-1, item_emb.shape[-1]),
                           s, self.similarity, self.temperature)


def _mf_specs(S):
    return (S("user_id", "categorical", "user", vocab_size=N_USERS,
              embedding_dim=DIM),
            S("friend_id", "categorical", "user", vocab_size=N_USERS,
              embedding_dim=DIM, share_embedding="user_id"),
            S("item_id", "categorical", "item", vocab_size=N_ITEMS,
              embedding_dim=DIM))


def _mf_setup():
    kw = dict(query_index="user_id", corpus_index="item_id",
              num_items=N_ITEMS)
    jfm = JFeatureMap("s", _mf_specs(JFeatureSpec), **kw)
    pfm = FeatureMap("s", _mf_specs(FeatureSpec), **kw)
    rng = np.random.default_rng(0)
    data = {"user_id": rng.integers(0, N_USERS, 4 * B).astype(np.int32),
            "friend_id": rng.integers(0, N_USERS, 4 * B).astype(np.int32),
            "item_id": rng.integers(0, N_ITEMS, 4 * B).astype(np.int32)}
    loader = MatchingLoader(pfm, data, {"item_id": np.arange(
        N_ITEMS, dtype=np.int32)}, batch_size=B, num_negs=2, seed=1)
    pbatches = list(loader)[:3]
    jbatches = [{"user_id": b["user_id"], "friend_id": b["friend_id"],
                 "item_id": b["item::item_id"],
                 "__item_ids__": b["__item_ids__"]} for b in pbatches]
    jloss = jget_matching_loss("PairwiseLogisticLoss")
    ploss = get_matching_loss("PairwiseLogisticLoss")
    jt = JSparseTrainer(_JRowsMF(feature_map=jfm, embedding_dim=DIM),
                        lambda o, b: jloss(o), JTrainerConfig(**CFG))
    pm = MF(pfm, embedding_dim=DIM, device="cpu",
            generator=torch.Generator().manual_seed(5))
    pt = SparseEmbeddingTrainer(pm, lambda o, b: ploss(o),
                                TrainerConfig(**CFG), device="cpu")
    return jt, pt, jbatches, pbatches


def _deepfm_specs(S):
    return tuple(S(f"c{i}", "categorical", vocab_size=9, embedding_dim=DIM)
                 for i in range(2)) + (
        S("c2", "categorical", vocab_size=9, embedding_dim=DIM,
          share_embedding="c0"),)


def _deepfm_setup():
    jfm = JFeatureMap("d", _deepfm_specs(JFeatureSpec), labels=("y",))
    pfm = FeatureMap("d", _deepfm_specs(FeatureSpec), labels=("y",))
    rng = np.random.default_rng(1)
    batches = [{"c0": rng.integers(0, 9, B).astype(np.int32),
                "c1": rng.integers(0, 9, B).astype(np.int32),
                "c2": rng.integers(0, 9, B).astype(np.int32),
                "y": (rng.random(B) > 0.5).astype(np.float32)}
               for _ in range(3)]
    jt = JSparseTrainer(JDeepFM(feature_map=jfm, embedding_dim=DIM,
                                hidden_units=(16,)),
                        lambda o, b: jbce(o, b["y"]), JTrainerConfig(**CFG))
    pm = DeepFM(pfm, embedding_dim=DIM, hidden_units=(16,), device="cpu",
                generator=torch.Generator().manual_seed(5))
    pt = SparseEmbeddingTrainer(pm, lambda o, b: binary_crossentropy(
        o, b["y"]), TrainerConfig(**CFG), device="cpu")
    return jt, pt, batches, batches


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(tree))


@pytest.mark.parametrize("setup", [_mf_setup, _deepfm_setup],
                         ids=["mf", "deepfm"])
def test_three_steps_match_jax(setup):
    jt, pt, jbatches, pbatches = setup()
    jt.init(jbatches[0])
    pt.model.load_state_dict(from_jax_params(_np(jt.full_params()),
                                             pt.model))
    pt.init(pbatches[0])
    assert set(pt.tables) == set(jt.tables)
    for step, (jb, pb) in enumerate(zip(jbatches, pbatches)):
        if step == 2:                      # a plateau: lr and emb_lr / 10
            jt._set_learning_rate(jt.learning_rate * 0.1)
            pt._set_learning_rate(pt.learning_rate * 0.1)
            np.testing.assert_allclose(pt.emb_lr, jt._emb_lr, rtol=1e-7)
        jl = float(jt.train_step(dict(jb)))
        pl_ = float(pt.train_step(dict(pb)))
        np.testing.assert_allclose(pl_, jl, rtol=1e-6)
    for k in jt.tables:
        want = np.asarray(jt.tables[k])
        np.testing.assert_allclose(pt.tables[k].detach().numpy(), want,
                                   rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)
        np.testing.assert_allclose(pt.accumulators[k].numpy(),
                                   np.asarray(jt.accumulators[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    want = from_jax_params(_np(jt.full_params()), pt.model)
    for k, v in pt.params.items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_duplicates_take_the_summed_accumulator():
    """Two occurrences of one id: both scaled by emb_lr / sqrt(g1² + g2²)
    (means over D), not the first by its own g² alone."""
    _, pt, _, pbatches = _mf_setup()
    pt.init(pbatches[0])
    key = "user_embedding/emb_user_id"
    table0 = pt.tables[key].detach().clone()
    b = {k: v[:2] for k, v in pbatches[0].items()}
    b["user_id"][:] = 4
    b["friend_id"][:] = 7
    rows = {}
    # the row gradients of the step, by the same forward
    pt.model.train()
    r = {f"__rows__user_embedding:{f}": table0[torch.as_tensor(b[f]).long()]
         .clone().requires_grad_(True) for f in ("user_id", "friend_id")}
    out = pt.model({**{k: torch.as_tensor(v) for k, v in b.items()}, **r,
                    "item::__rows__item_embedding:item_id": pt.tables[
                        "item_embedding/emb_item_id"].detach()[
                        torch.as_tensor(b["item::item_id"]).long()]})
    loss = pt.loss_fn(out, b) + CFG["embedding_regularizer"] * 0.5 * sum(
        torch.sum(t ** 2) for t in r.values()) \
        + CFG["embedding_regularizer"] * 0.5 * torch.sum(pt.tables[
            "item_embedding/emb_item_id"].detach()[torch.as_tensor(
                b["item::item_id"]).long()] ** 2)
    g = torch.autograd.grad(loss, list(r.values()))
    rows["user"] = g[0]                     # (2, D): id 4 twice
    pt.train_step(b)
    g4 = rows["user"]
    v = torch.mean(g4 ** 2, dim=-1).sum()
    want = table0[4] - sum(CFG["learning_rate"] / (torch.sqrt(v) + 1e-8)
                           * g4[i] for i in range(2))
    torch.testing.assert_close(pt.tables[key][4].detach(), want, rtol=1e-6,
                               atol=1e-9)
    torch.testing.assert_close(pt.accumulators[key][4], v, rtol=1e-6,
                               atol=0.0)


def test_save_load_round_trip(tmp_path):
    _, pt, _, pbatches = _mf_setup()
    for b in pbatches[:2]:
        pt.train_step(dict(b))
    pt._set_learning_rate(pt.learning_rate * 0.1)
    path = str(tmp_path / "sparse.ckpt")
    pt.save(path)
    _, fresh, _, _ = _mf_setup()
    fresh.init(pbatches[0])
    fresh.load(path)
    assert fresh.step == pt.step and fresh.emb_lr == pt.emb_lr
    for k in pt.tables:
        assert torch.equal(fresh.tables[k], pt.tables[k])
        assert torch.equal(fresh.accumulators[k], pt.accumulators[k])
    # the tables are the model's own parameters, written in place
    assert fresh.tables["item_embedding/emb_item_id"] is \
        fresh.model.item_embedding.tables["item_id"]
    a = fresh.train_step(dict(pbatches[2]))
    b = pt.train_step(dict(pbatches[2]))
    assert torch.equal(a, b)


def test_restore_best_writes_in_place():
    _, pt, _, pbatches = _mf_setup()
    pt.train_step(dict(pbatches[0]))
    pt._capture_best()
    key = "item_embedding/emb_item_id"
    live, best = pt.tables[key], pt.tables[key].detach().clone()
    acc = pt.accumulators[key].clone()
    pt.train_step(dict(pbatches[1]))
    assert not torch.equal(live, best)
    pt._restore_best()
    assert pt.tables[key] is live and torch.equal(live, best)
    assert torch.equal(pt.accumulators[key], acc)


def test_train_steps_fused_equals_k_steps_on_cpu():
    runs = []
    for fused in (True, False):
        _, pt, _, pbatches = _mf_setup()
        if fused:
            losses = pt.train_steps_fused(
                {k: np.stack([b[k] for b in pbatches]) for k in pbatches[0]})
        else:
            losses = torch.stack([pt.train_step(dict(b)) for b in pbatches])
        runs.append((losses, pt))
    (la, a), (lb, b) = runs
    assert torch.equal(la, lb) and a.step == b.step == 3
    for k in a.tables:
        assert torch.equal(a.tables[k], b.tables[k])
        assert torch.equal(a.accumulators[k], b.accumulators[k])
    rep = a.train_steps_repeat(
        {k: v for k, v in next(iter(ArrayLoader(
            {k: v[:B] for k, v in pbatches[0].items()}, batch_size=B,
            shuffle=False))).items() if k != "__mask__"}, 2)
    assert rep.shape == (2,) and a.step == 5
