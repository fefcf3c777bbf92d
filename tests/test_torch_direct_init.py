"""Abstract tables, `PackedEmbeddingTrainer`'s direct init and `emb_init`,
on the CPU.

A model built under `nn.abstract_tables()` has its tables as shapes on the
meta device (JAX's abstract init before its direct init); only the packed
trainer's direct init can train it, and it draws the pack the way it draws
one for a model built as usual. The pipelines draw a model's initial
weights from a host generator seeded with the config's seed
(`quick_start._seeded_build`).
"""

import numpy as np
import pytest
import torch

from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.models.ranking.ctr import DeepFM
from recbox_tpu_torch.nn import abstract_tables, emb_init
from recbox_tpu_torch.ops import binary_crossentropy
from recbox_tpu_torch.quick_start import build_model
from recbox_tpu_torch.training import Trainer, TrainerConfig
from recbox_tpu_torch.training.packed import PackedEmbeddingTrainer

VOCAB, DIM, B = 500, 8, 128


def _fm():
    return FeatureMap("t", tuple(
        FeatureSpec(f"c{i}", "categorical", vocab_size=VOCAB,
                    embedding_dim=DIM) for i in range(3)) + (
        FeatureSpec("n0", "numeric", embedding_dim=DIM),), labels=("click",))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    b = {f"c{i}": rng.integers(0, VOCAB, B).astype(np.int32)
         for i in range(3)}
    b["n0"] = rng.normal(size=B).astype(np.float32)
    b["click"] = (b["c0"] % 2).astype(np.float32)
    return b


def _trainer(model, **kw):
    return PackedEmbeddingTrainer(
        model, lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(learning_rate=1e-3, seed=5), device="cpu", **kw)


def test_abstract_tables_hold_no_bytes():
    with abstract_tables():
        model = DeepFM(_fm(), embedding_dim=DIM, hidden_units=(16,),
                       device="cpu")
    tables = {n: p for n, p in model.named_parameters() if ".tables." in n}
    assert len(tables) == 6 and all(p.is_meta for p in tables.values())
    assert tuple(tables["embedding.tables.c0"].shape) == (VOCAB, DIM)
    # the dense parameters are real; outside the context tables are drawn
    assert not any(p.is_meta for n, p in model.named_parameters()
                   if ".tables." not in n)
    plain = DeepFM(_fm(), embedding_dim=DIM, hidden_units=(16,),
                   device="cpu")
    assert not any(p.is_meta for p in plain.parameters())


@pytest.mark.parametrize("direct_init", [True, None])
def test_direct_init_trains_abstract_tables(direct_init):
    """The pack of an abstract model is the one a model built as usual
    gets from the direct init (the same draw from the trainer's seed), and
    training moves it."""
    with abstract_tables():
        abstract = DeepFM(_fm(), embedding_dim=DIM, hidden_units=(16,),
                          device="cpu")
    built = DeepFM(_fm(), embedding_dim=DIM, hidden_units=(16,),
                   device="cpu")
    ta = _trainer(abstract, direct_init=direct_init)
    tb = _trainer(built, direct_init=True)
    batch = _batch()
    ta.init(batch)
    tb.init(batch)
    (name, pack), = ta.packs.items()
    assert torch.equal(pack, tb.packs[name])
    assert not any(".tables." in n for n, _ in abstract.named_parameters())
    losses = [float(ta.train_step(_batch())) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_abstract_tables_refuse_the_exact_init_and_the_dense_trainer():
    with abstract_tables():
        model = DeepFM(_fm(), embedding_dim=DIM, hidden_units=(16,),
                       device="cpu")
    with pytest.raises(ValueError, match="abstract_tables"):
        _trainer(model, direct_init=False).init(_batch())
    with abstract_tables():
        model = DeepFM(_fm(), embedding_dim=DIM, hidden_units=(16,),
                       device="cpu")
    with pytest.raises(NotImplementedError):
        Trainer(model, lambda o, b: binary_crossentropy(o, b["click"]),
                TrainerConfig(), device="cpu")


def test_emb_init_draws_normal_std_from_the_generator():
    init = emb_init(0.05)
    a = init((4000, 16), torch.Generator().manual_seed(3), "cpu")
    b = init((4000, 16), torch.Generator().manual_seed(3), "cpu")
    assert isinstance(a, torch.nn.Parameter) and tuple(a.shape) == (4000, 16)
    assert torch.equal(a, b)
    a = a.detach()
    assert abs(float(a.std()) - 0.05) < 1e-3 and abs(float(a.mean())) < 1e-3
    small = emb_init()((4000, 16), torch.Generator().manual_seed(1), "cpu")
    assert abs(float(small.detach().std()) - 1e-4) < 2e-6


def test_pipeline_draws_on_the_host_from_the_seed():
    """`build_model` on the CPU is the host draw itself: two builds with one
    seed agree bit for bit, another seed differs."""
    cfg = {"model": "DeepFM", "embedding_dim": DIM, "hidden_units": [16],
           "seed": 11}
    a, _ = build_model(cfg, _fm(), "cpu")
    b, _ = build_model(cfg, _fm(), "cpu")
    c, _ = build_model({**cfg, "seed": 12}, _fm(), "cpu")
    for (n, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.state_dict()["embedding.tables.c0"],
                           c.state_dict()["embedding.tables.c0"])
