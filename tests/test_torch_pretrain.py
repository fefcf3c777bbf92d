"""S3Rec, GRU4RecF and the pretraining phase against the JAX package's, on
the CPU.

`reconstruct_pretrain_batch` is held bit for bit to JAX's from the same
`np.random.Generator` state, with and without an attribute table. S3Rec
(d = 16, L = 8, 1 layer, 2 heads, 30 items and PAD, 5 attributes, dropout
0) on JAX's weights: the MIP / SP / AAP heads, `pretrain_losses` and its
gradients, and the fine-tune `full_scores`; GRU4RecF with and without its
feature column. Then the phase itself: one epoch of `S3RecPretrainer` on
both packages from the same weights and seed (the same batches, drawn
from ``default_rng(seed)``) ends at the same weights; the port's
pretrain-then-fine-tune schedule of JAX's
`tests/test_pretrain_schedule.py:89` (the joint loss falls on a fixed
probe batch, `transfer_pretrained` grafts the pretrained parameters and
keeps the causal encoder's fresh draw, a fine-tune step runs) and its
per-epoch checkpoints.

Tolerances: scores, losses rtol 1e-5 (atol 1e-6 of the largest value:
other summation orders); gradients rtol 1e-4 (atol 1e-4 of the largest
gradient, the sequential zoo's rule: the pretrain losses are sums over
positions, and a gradient that is 0 in exact arithmetic comes out as
rounding noise on both sides); the pretrainer's
Adam epoch by `check_adam_state` (SASRec's rule,
`tests/test_torch_sequence_ctr.py`).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.sequential import pretrain as JP
from recbox_tpu.training import pretrain as jpre
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models.sequential import GRU4RecF, S3Rec
from recbox_tpu_torch.ops.losses import full_softmax_loss
from recbox_tpu_torch.training import Trainer, TrainerConfig
from recbox_tpu_torch.training import pretrain as ppre
from recbox_tpu_torch.training.checkpoint import load_checkpoint
from test_torch_sequence_ctr import check_adam_state

N_ITEMS, L, DIM, A, FV = 30, 8, 16, 5, 6


def _fm(FM, FS):
    return FM("s3p", (FS("item_id", "categorical", source="item",
                         vocab_size=N_ITEMS + 1, embedding_dim=DIM),),
              query_index="user_id", corpus_index="item_id",
              num_items=N_ITEMS + 1)


def _seqs(rng, n=64):
    """Right-padded histories, as the pretrain phase takes them."""
    seq_len = rng.integers(1, L + 1, n).astype(np.int32)
    seq_len[0] = L
    seqs = rng.integers(1, N_ITEMS, size=(n, L)).astype(np.int32)
    seqs[np.arange(L)[None, :] >= seq_len[:, None]] = 0
    return seqs, seq_len


def _attributes(seed=1):
    att = (np.random.default_rng(seed).random((N_ITEMS + 2, A)) > 0.6
           ).astype(np.float32)
    att[0] = 0
    return att


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  fnn.meta.unbox(tree))


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got, want, rtol=1e-5, atol_rel=1e-6):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=rtol,
        atol=atol_rel * float(np.max(np.abs(want))))


@pytest.mark.parametrize("seed,ratio,with_att", [(0, 0.2, False),
                                                 (3, 0.5, True),
                                                 (11, 0.9, True)])
def test_reconstruct_pretrain_batch_is_jax_bit_for_bit(seed, ratio,
                                                       with_att):
    seqs, seq_len = _seqs(np.random.default_rng(seed + 100))
    att = _attributes() if with_att else None
    want = jpre.reconstruct_pretrain_batch(
        seqs, seq_len, N_ITEMS + 1, N_ITEMS + 1,
        np.random.default_rng(seed), ratio, att)
    got = ppre.reconstruct_pretrain_batch(
        seqs, seq_len, N_ITEMS + 1, N_ITEMS + 1,
        np.random.default_rng(seed), ratio, att)
    assert list(got) == list(want)
    assert ("attributes" in got) == with_att
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _s3rec_pair(n_attributes=A):
    kw = dict(embedding_dim=DIM, max_seq_len=L, n_layers=1, n_heads=2,
              dropout=0.0, n_attributes=n_attributes)
    jm = JP.S3Rec(feature_map=_fm(JFeatureMap, JFeatureSpec), **kw)
    pm = S3Rec(_fm(FeatureMap, FeatureSpec), device="cpu", **kw)
    return jm, pm


def _s3rec_params(jm, probe):
    """JAX's full tree: the pretrain subtrees (emb_item, encoder, sp_w,
    aap_w) and the fine-tune ones (causal, pos)."""
    key = jax.random.PRNGKey(0)
    pre = _np_tree(jm.init(key, probe, method=jm.pretrain_losses))["params"]
    fine = _np_tree(jm.init(key, {"item_seq": probe["masked_seq"],
                                  "seq_len": probe["seq_len"]},
                            method=jm.full_scores))["params"]
    return {**fine, **pre}


def _probe(seed=5, att=True):
    seqs, seq_len = _seqs(np.random.default_rng(seed), n=12)
    return jpre.reconstruct_pretrain_batch(
        seqs, seq_len, N_ITEMS + 1, N_ITEMS + 1, np.random.default_rng(seed),
        0.3, _attributes() if att else None)


def test_s3rec_heads_and_losses_match_jax():
    jm, pm = _s3rec_pair()
    probe = _probe()
    params = _s3rec_params(jm, probe)
    pm.load_state_dict(from_jax_params(params, pm))
    tb = _tb(probe)
    v = {"params": params}
    seq, sl = probe["masked_seq"], probe["seq_len"]
    positions = np.tile(np.arange(2, 6, dtype=np.int32), (len(seq), 1))
    _close(pm.mip_logits(tb["masked_seq"], tb["seq_len"],
                         torch.from_numpy(positions)).detach(),
           jm.apply(v, seq, sl, positions, method=jm.mip_logits))
    for got, want in zip(
            pm.sp_logits(tb["masked_segment"], tb["seq_len"],
                         tb["pos_segment"], tb["seq_len"],
                         tb["neg_segment"], tb["seq_len"]),
            jm.apply(v, probe["masked_segment"], sl, probe["pos_segment"],
                     sl, probe["neg_segment"], sl, method=jm.sp_logits)):
        _close(got.detach(), want)
    _close(pm.aap_logits(tb["masked_seq"], tb["seq_len"]).detach(),
           jm.apply(v, seq, sl, method=jm.aap_logits))
    for weights in ((0.2, 1.0, 1.0, 0.5), (1.0, 0.0, 2.0, 0.3)):
        jl, jg = jax.value_and_grad(lambda p: jm.apply(
            {"params": p}, probe, weights=weights, train=False,
            method=jm.pretrain_losses))(params)
        pm.zero_grad()
        loss = pm.pretrain_losses(tb, weights=weights)
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=1e-5)
        loss.backward()
        named = dict(pm.named_parameters())
        expect = from_jax_params({**params, **_np_tree(jg)}, pm)
        top = max(float(np.abs(g).max())
                  for g in jax.tree_util.tree_leaves(_np_tree(jg)))
        for k in _np_tree(jg):
            for name, g in expect.items():
                if not name.startswith(k):
                    continue
                if name.startswith(("causal.", "pos.")):
                    assert not g.any(), name
                    continue
                np.testing.assert_allclose(named[name].grad.numpy(),
                                           g.numpy(), rtol=1e-4,
                                           atol=1e-4 * top, err_msg=name)
        # the fine-tune side takes no gradient from the pretrain loss
        assert all(p.grad is None for n, p in named.items()
                   if n.startswith(("causal.", "pos.")))
    with pytest.raises(ValueError, match="n_attributes"):
        _s3rec_pair(0)[1].aap_logits(tb["masked_seq"], tb["seq_len"])


def test_s3rec_fine_tune_scores_match_jax():
    jm, pm = _s3rec_pair()
    probe = _probe()
    params = _s3rec_params(jm, probe)
    pm.load_state_dict(from_jax_params(params, pm))
    seqs, seq_len = _seqs(np.random.default_rng(6), n=10)
    left = ppre._left_pad(seqs, seq_len).astype(np.int32)
    batch = {"item_seq": left, "seq_len": seq_len}
    want = jm.apply({"params": params}, batch, method=jm.full_scores)
    got = pm.full_scores(_tb(batch)).detach()
    assert got.shape == (10, N_ITEMS + 1)   # the [MASK] row is not scored
    _close(got, want)
    assert pm.mask_token == N_ITEMS + 1
    assert tuple(pm.emb_item.shape) == (N_ITEMS + 2, DIM)


@pytest.mark.parametrize("feature_vocab", [0, FV])
def test_gru4recf_matches_jax(feature_vocab):
    kw = dict(embedding_dim=DIM, max_seq_len=L, hidden_size=12, n_layers=2,
              dropout=0.0, feature_vocab=feature_vocab)
    jm = JP.GRU4RecF(feature_map=_fm(JFeatureMap, JFeatureSpec), **kw)
    pm = GRU4RecF(_fm(FeatureMap, FeatureSpec), device="cpu", **kw)
    rng = np.random.default_rng(8)
    seqs, seq_len = _seqs(rng, n=10)
    left = ppre._left_pad(seqs, seq_len).astype(np.int32)
    batch = {"item_seq": left, "seq_len": seq_len,
             "feat_seq": np.where(left > 0, rng.integers(1, FV, left.shape),
                                  0).astype(np.int32),
             "item_id": rng.integers(1, N_ITEMS, 10).astype(np.int32)}
    params = _np_tree(jm.init(jax.random.PRNGKey(0), batch,
                              method=jm.full_scores))["params"]
    pm.load_state_dict(from_jax_params(params, pm))
    assert hasattr(pm, "emb_feat") == bool(feature_vocab)
    assert pm.gru4recf.GRUCell_0.ir.in_features == 2 * DIM

    def jloss(p):
        s = jm.apply({"params": p}, batch, method=jm.full_scores)
        return jnp.mean(jax.nn.logsumexp(s, -1) - jnp.take_along_axis(
            s, batch["item_id"][:, None], 1)[:, 0]), s

    (jl, js), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tb = _tb(batch)
    scores = pm.full_scores(tb)
    _close(scores.detach(), js)
    loss = full_softmax_loss(scores, tb["item_id"])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    expect = from_jax_params(_np_tree(jg), pm)
    top = max(float(g.abs().max()) for g in expect.values())
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expect[k].numpy(),
                                   rtol=1e-4, atol=1e-4 * top, err_msg=k)


def test_pretrainer_epoch_matches_jax():
    """One epoch of each package's `S3RecPretrainer` (one batch of 48,
    Adam 1e-2, mask ratio 0.3, attributes) from the same weights and seed:
    the same permutation and batch (the port draws them with a copy of
    JAX's function from the same ``default_rng(seed)``), the same
    pretrained weights. One step: the key biases' true gradient is 0, so
    each further Adam step moves them by another ±lr of rounding noise."""
    seqs, seq_len = _seqs(np.random.default_rng(2), n=48)
    att = _attributes()
    jm, pm = _s3rec_pair()
    probe = _probe()
    params = _s3rec_params(jm, probe)
    pm.load_state_dict(from_jax_params(params, pm))
    jp = jpre.S3RecPretrainer(jm, learning_rate=1e-2, mask_ratio=0.3,
                              attribute_table=att, seed=7)
    jp._init(probe)
    jp.params = jax.tree_util.tree_map(
        jnp.asarray, {k: params[k] for k in jp.params})
    jp.opt_state = jp.tx.init(jp.params)
    pp = ppre.S3RecPretrainer(pm, learning_rate=1e-2, mask_ratio=0.3,
                              attribute_table=att, seed=7)
    jout = jp.pretrain(seqs, seq_len, epochs=1, batch_size=48)
    pout = pp.pretrain(seqs, seq_len, epochs=1, batch_size=48)
    np.testing.assert_array_equal(jp._np_rng.random(4),
                                  pp._np_rng.random(4))
    assert set(pout) == {n for n, _ in pm.named_parameters()
                         if not n.startswith(("causal.", "pos."))}
    check_adam_state(pm, {**params, **_np_tree(jout)}, 1e-2)


def test_pretrain_then_fine_tune_schedule(tmp_path):
    """JAX's `test_pretrain_loss_decreases_and_transfer` on the port: the
    joint loss on a fixed probe falls from epoch 1 to epoch 4; the graft
    replaces the pretrained parameters and keeps the causal encoder's
    fresh draw; a fine-tune step runs on the grafted model; an atomic
    checkpoint an epoch."""
    rng = np.random.default_rng(2)
    seqs, seq_len = _seqs(rng, n=96)
    att = _attributes()
    kw = dict(embedding_dim=DIM, max_seq_len=L, n_layers=1, n_heads=2,
              dropout=0.0, n_attributes=A)
    model = S3Rec(_fm(FeatureMap, FeatureSpec), device="cpu", **kw)
    pre = ppre.S3RecPretrainer(model, learning_rate=1e-2, mask_ratio=0.3,
                               attribute_table=att, seed=0,
                               workdir=str(tmp_path))
    probe = _tb(ppre.reconstruct_pretrain_batch(
        seqs[:32], seq_len[:32], N_ITEMS + 1, N_ITEMS + 1,
        np.random.default_rng(42), 0.3, att))
    pre.pretrain(seqs, seq_len, epochs=1, batch_size=32)
    model.eval()
    loss1 = float(model.pretrain_losses(probe))
    params = pre.pretrain(seqs, seq_len, epochs=3, batch_size=32)
    model.eval()
    loss2 = float(model.pretrain_losses(probe))
    assert np.isfinite(loss1) and loss2 < loss1, (loss1, loss2)
    assert sorted(os.listdir(tmp_path)) == [f"pretrain-{e}.ckpt"
                                            for e in range(3)]
    saved = load_checkpoint(str(tmp_path / "pretrain-2.ckpt"))
    assert saved["epoch"] == 2
    assert torch.equal(saved["params"]["emb_item"], params["emb_item"])

    fine = S3Rec(_fm(FeatureMap, FeatureSpec), device="cpu",
                 generator=torch.Generator().manual_seed(9), **kw)
    fresh_causal = fine.causal.q0.weight.detach().clone()
    fine.load_state_dict(ppre.transfer_pretrained(fine.state_dict(),
                                                  params))
    assert torch.equal(fine.emb_item, params["emb_item"])
    assert torch.equal(fine.encoder.encoder.q0.weight,
                       params["encoder.encoder.q0.weight"])
    assert torch.equal(fine.causal.q0.weight, fresh_causal)
    tr = Trainer(fine, lambda o, b: full_softmax_loss(o, b["target"]),
                 TrainerConfig(learning_rate=1e-3, monitor="AUC"),
                 device="cpu", train_method="full_scores")
    left = ppre._left_pad(seqs[:8], seq_len[:8]).astype(np.int32)
    loss = tr.train_step({"item_seq": left, "seq_len": seq_len[:8],
                          "target": left[:, -1]})
    assert np.isfinite(float(loss))


def test_pretrain_with_dataset_smaller_than_batch():
    seqs, seq_len = _seqs(np.random.default_rng(9), n=20)
    model = S3Rec(_fm(FeatureMap, FeatureSpec), embedding_dim=DIM,
                  max_seq_len=L, n_layers=1, n_heads=2, dropout=0.0,
                  device="cpu")
    pre = ppre.S3RecPretrainer(model, learning_rate=1e-2, mask_ratio=0.3,
                               seed=0)
    before = model.emb_item.detach().clone()
    pre.pretrain(seqs, seq_len, epochs=1, batch_size=256)
    assert len(pre.epoch_losses) == 1
    assert not torch.equal(before, model.emb_item)
    with pytest.raises(ValueError, match="at least one"):
        pre.pretrain(seqs[:0], seq_len[:0])
