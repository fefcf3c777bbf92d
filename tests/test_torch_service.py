"""`RetrievalService.from_trainer` of the port against the JAX package's, on
the CPU.

A port `Trainer(MF)` and a `SparseEmbeddingTrainer(MF)`, each three steps
from the JAX model's transplanted weights on the same `MatchingLoader`
batches, served through ``from_trainer`` (method 'auto'), against JAX's
``from_trainer`` on the JAX trainer after the same steps (the sparse
trainer's JAX side as in `test_torch_sparse_trainer.py`: a test-local MF
whose item tower reads the candidates' rows): the top-k ids per query are
JAX's, the winners tied with the k-th aside (`_sets_equal_but_ties`), and
the scores within rtol 1e-5 / atol 1e-7 (f32 towers after three steps in
two frameworks). The service serves the trainer's live tables (no copy),
in eval mode, on the trainer's device.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from recbox_tpu.retrieval import RetrievalService as JRetrievalService
from recbox_tpu.training import Trainer as JTrainer
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.ops import get_matching_loss as jget_matching_loss
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.ops.losses import get_matching_loss
from recbox_tpu_torch.retrieval import RetrievalService
from recbox_tpu_torch.training import Trainer, TrainerConfig
from tests.test_torch_retrieval import _sets_equal_but_ties
from tests.test_torch_sparse_trainer import CFG, N_ITEMS, N_USERS, _mf_setup


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(tree))


def _dense_pair():
    """A JAX `Trainer(MF)` and the port's, from `_mf_setup`'s models."""
    jt_s, pt_s, jbatches, pbatches = _mf_setup()
    jloss = jget_matching_loss("PairwiseLogisticLoss")
    ploss = get_matching_loss("PairwiseLogisticLoss")
    jt = JTrainer(jt_s.model, lambda o, b: jloss(o), JTrainerConfig(**CFG))
    pt = Trainer(pt_s.model, lambda o, b: ploss(o), TrainerConfig(**CFG),
                 device="cpu")
    return jt, pt, jbatches, pbatches


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_from_trainer_matches_jax(kind):
    jt, pt, jbatches, pbatches = (_dense_pair if kind == "dense"
                                  else _mf_setup)()
    jt.init(jbatches[0])
    pt.model.load_state_dict(from_jax_params(
        _np(jt.full_params() if kind == "sparse" else jt.params), pt.model))
    pt.init(pbatches[0])
    for jb, pb in zip(jbatches, pbatches):
        jt.train_step(dict(jb))
        pt.train_step(dict(pb))
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    users = {"user_id": np.arange(N_USERS, dtype=np.int32),
             "friend_id": (np.arange(N_USERS, dtype=np.int32) * 5)
             % N_USERS}
    jsvc = JRetrievalService.from_trainer(jt, corpus)
    psvc = RetrievalService.from_trainer(pt, corpus)
    assert psvc.device == pt.device and psvc.method == "auto"
    assert not pt.model.training
    if kind == "sparse":                   # the live tables, no copy
        assert psvc.model.item_embedding.tables["item_id"] is \
            pt.tables["item_embedding/emb_item_id"]
    for k in (5, N_ITEMS):
        js, ji = jsvc.query(users, k=k)
        ps, pi = psvc.query(users, k=k)
        assert pi.shape == ji.shape == (N_USERS, k)
        assert _sets_equal_but_ties(ps, pi, js, ji)
        np.testing.assert_allclose(ps, np.asarray(js), rtol=1e-5, atol=1e-7)
    # the service encodes with the trained weights, not the initial ones
    emb = psvc.item_embs
    assert torch.equal(emb, pt.model.encode_item(
        {"item_id": torch.arange(N_ITEMS)}).detach())
