"""The port's table-placement planner and comm model against the JAX
package's, and the port's counted collective bytes against the model.

Mirrors `tests/test_placement.py`. The planner's cost constants are the
card's in the port (`parallel/placement.py`); the parity cases set them to
JAX's TPU values and compare the plans. The counted bytes come from the
port's recorder over one dense `Trainer` step in four gloo ranks
(`torch_parallel_workers.comm_bytes`) and must equal
`predict_step_comm_bytes` within 1%.
"""

import jax
import numpy as np
import pytest

import torch_parallel_workers as W
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.parallel import placement as jplacement
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.parallel import placement as tplacement

BIG, SMALL, BATCH, DIM, HIDDEN = 4096, 64, 256, 16, (32,)
CASES = [("mixed", 2), ("mixed", 4), ("replicated", 2), ("sharded", 4),
         ("replicated", 4)]


@pytest.fixture
def jax_constants(monkeypatch):
    monkeypatch.setattr(tplacement, "LAT_ROW", jplacement.LAT_ROW)
    monkeypatch.setattr(tplacement, "LINK_BYTES_PER_S",
                        jplacement.ICI_BYTES_PER_S)


PLANS = [
    dict(table_shapes={"gender": (4, 16), "country": (256, 16),
                       "item_id": (2_000_000, 64)}, n_devices=8,
         batch_size=8192),
    dict(table_shapes={"a": (100_000, 64), "b": (100_000, 64)}, n_devices=8,
         hbm_budget_bytes=100_000 * 64 * 4,
         touches_per_step={"a": 1e9, "b": 1e9}),
    dict(table_shapes={"cold": (5_000_000, 64)},
         touches_per_step={"cold": 10.0}, n_devices=8),
    dict(table_shapes={f"t{i}": (10 ** (i % 7 + 1), 8 * (i % 4 + 1))
                       for i in range(12)}, n_devices=4, batch_size=2048,
         hbm_budget_bytes=2 ** 22),
]


@pytest.mark.parametrize("kwargs", PLANS)
def test_planner_matches_jax_at_jax_constants(jax_constants, kwargs):
    want = jplacement.plan_table_placement(**kwargs)
    got = tplacement.plan_table_placement(**kwargs)
    assert set(got) == set(want)
    for name, p in want.items():
        q = got[name]
        assert (q.name, q.rows, q.dim, q.touches_per_step, q.replicate,
                q.hbm_cost_bytes) == (p.name, p.rows, p.dim,
                                      p.touches_per_step, p.replicate,
                                      p.hbm_cost_bytes)
        assert q.step_saving_s == pytest.approx(p.step_saving_s, rel=1e-12)


def test_planner_at_the_cards_constants():
    """The card's constants: small hot tables replicate, a huge one
    shards, and nothing carries a TPU figure."""
    assert tplacement.LINK_BYTES_PER_S != jplacement.ICI_BYTES_PER_S
    assert tplacement.LAT_ROW != jplacement.LAT_ROW
    plans = tplacement.plan_table_placement(
        {"gender": (4, 16), "item_id": (20_000_000, 64)}, n_devices=8,
        batch_size=8192)
    assert plans["gender"].replicate and not plans["item_id"].replicate


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 2), (1, 4), (4, 1),
                                            (4, 2)])
def test_comm_model_matches_jax(n_data, n_model):
    tables = [(BIG, DIM, True), (BIG, 1, True), (SMALL, DIM, False),
              (SMALL, 1, False, 77.0)]
    assert tplacement.predict_step_comm_bytes(
        tables, BATCH, n_data, n_model, 1234) == \
        jplacement.predict_step_comm_bytes(tables, BATCH, n_data, n_model,
                                           1234)


def test_apply_placement_writes_shard_table():
    fm = FeatureMap("pl", (
        FeatureSpec("gender", "categorical", vocab_size=4, embedding_dim=8),
        FeatureSpec("item_id", "categorical", vocab_size=2_000_000,
                    embedding_dim=64),
    ), labels=("y",))
    jfm = JFeatureMap("pl", tuple(JFeatureSpec(**{
        k: getattr(s, k) for k in ("name", "type", "vocab_size",
                                   "embedding_dim")}) for s in fm.features),
        labels=("y",))
    plans = tplacement.plan_table_placement(
        {"gender": (4, 8), "item_id": (2_000_000, 64)}, n_devices=8)
    fm2 = tplacement.apply_placement(fm, plans)
    jfm2 = jplacement.apply_placement(jfm, plans)
    assert fm2["gender"].shard_table is False
    assert fm2["item_id"].shard_table is True
    assert fm["gender"].shard_table is None
    assert fm2.to_json() == jfm2.to_json()


def test_feature_embedding_honors_shard_table_flag(tmp_path):
    """A spec's ``shard_table`` decides, else the module's
    ``shard_tables``; the flag survives the schema's JSON."""
    from recbox_tpu_torch.nn.embedding import FeatureEmbedding
    fm = FeatureMap("plc", (
        FeatureSpec("small", "categorical", vocab_size=8, embedding_dim=8,
                    shard_table=False),
        FeatureSpec("big", "categorical", vocab_size=64, embedding_dim=8),
    ), labels=("y",))
    mod = FeatureEmbedding(fm, device="cpu")
    assert not mod.table_sharded("small") and mod.table_sharded("big")
    mod2 = FeatureEmbedding(fm, device="cpu", shard_tables=False)
    assert not mod2.table_sharded("big")
    fm.save(str(tmp_path / "fm.json"))
    fm3 = FeatureMap.load(str(tmp_path / "fm.json"))
    assert fm3["small"].shard_table is False
    assert fm3["big"].shard_table is None


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placement")
    return W.run("comm_bytes", 4, tmp, cases=CASES, vocab=BIG, small=SMALL,
                 batch_rows=BATCH, dim=DIM, hidden=HIDDEN)


def _predicted(placement, n_model, dense):
    shard_big = placement in ("sharded", "mixed")
    shard_small = placement == "sharded"
    tables = [(BIG, DIM, shard_big), (BIG, 1, shard_big),
              (SMALL, DIM, shard_small), (SMALL, 1, shard_small)]
    return tplacement.predict_step_comm_bytes(
        tables, BATCH, 4 // n_model, n_model, dense)["total"]


@pytest.mark.parametrize("placement,m", CASES[:4])
def test_counted_bytes_match_the_model(counted, placement, m):
    """Every rank issues the collectives the model predicts, to within 1%
    (the rest is the loss and the clip norm, 4 bytes each). Unlike JAX's
    XLA, the port assembles a sharded table of fewer rows than the batch
    batch-shaped too, so its 'sharded' case is exact as well."""
    for r in range(4):
        got = int(counted[r][f"{placement}/m{m}/bytes"])
        pred = _predicted(placement, m, int(counted[r][f"{placement}/m{m}/"
                                                       "dense"]))
        assert pred > 0
        assert abs(got - pred) / pred < 0.01, (placement, m, got, pred)


def test_fully_replicated_single_data_shard_is_comm_free(counted):
    for r in range(4):
        assert int(counted[r]["replicated/m4/bytes"]) == 0


def test_parse_collectives_on_jax_hlo_equals_jax():
    """`parse_collectives` is JAX's: on the HLO of a JAX sharded step it
    finds JAX's ops, kinds and bytes."""
    from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
    from recbox_tpu.ops import binary_crossentropy as jbce
    from recbox_tpu.parallel import make_mesh as jmake_mesh
    from recbox_tpu.parallel.inspect import collective_summary as jsummary
    from recbox_tpu.parallel.inspect import parse_collectives as jparse
    from recbox_tpu.training import Trainer as JTrainer
    from recbox_tpu.training import TrainerConfig as JTrainerConfig
    from recbox_tpu_torch.parallel.inspect import (
        collective_summary, parse_collectives,
    )
    fm = W.feature_map(JFeatureSpec, JFeatureMap, (BIG, SMALL), DIM,
                       (True, False), names=("big", "small"))
    rng = np.random.default_rng(0)
    b = {"big": rng.integers(0, BIG, BATCH).astype(np.int32),
         "small": rng.integers(0, SMALL, BATCH).astype(np.int32),
         "click": (rng.random(BATCH) > 0.5).astype(np.float32)}
    t = JTrainer(JDeepFM(feature_map=fm, embedding_dim=DIM,
                         hidden_units=HIDDEN),
                 lambda o, bb: jbce(o, bb["click"]),
                 JTrainerConfig(learning_rate=1e-2, monitor="AUC"),
                 mesh=jmake_mesh(num_model_shards=2))
    t.init(b)
    hlo = t._build_train_step().lower(
        t.params, t.model_state, t.opt_state, t._device_batch(b),
        jax.random.PRNGKey(0)).compile().as_text()
    want, got = jparse(hlo), parse_collectives(hlo)
    assert got and [(o.kind, o.result_shape, o.bytes) for o in got] == \
        [(o.kind, o.result_shape, o.bytes) for o in want]
    assert collective_summary(got) == jsummary(want)
