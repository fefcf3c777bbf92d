"""The data and features pipeline as a whole, the port against the JAX
package, on the CPU: raw Criteo-layout rows → each package's
`FeatureEncoder` → JAX's npz shards → each package's `ShardLoader` → one
epoch of each package's `PackedEmbeddingTrainer(DeepFM).fit`.

The rows are a small copy of `chip_smoke.py` phase 5q's: a label, integer
counts (log-normal, rounded, ~20% NaN) and 8-hex-digit tokens (Zipf, some
empty), clicks from a planted logistic model on the raw tokens of two
fields. The encoded arrays and the loaders' batches must be equal bit for
bit; the port's trainer starts from the JAX trainer's initial state
(`interop.load_packed_state`, as `tests/test_torch_packed_layouts.py`
pairs them), and the fp32 path's per-step losses agree within rtol 1e-5
(AdaGrad on the packs and Adam on the dense weights divide by small second
moments: relative differences of 1e-7 in the gradients grow over the
epoch), the final packs within rtol 1e-5 / atol 1e-6 and the held-out
predictions within rtol 1e-4 / atol 1e-5.
"""

import jax
import numpy as np
import pytest

import flax.linen as fnn
from recbox_tpu.data.shards import ShardLoader as JShardLoader
from recbox_tpu.data.shards import save_shards as jsave_shards
from recbox_tpu.features import FeatureEncoder as JFeatureEncoder
from recbox_tpu.models.ranking.ctr import DeepFM as JDeepFM
from recbox_tpu.ops import binary_crossentropy as jbce
from recbox_tpu.training import TrainerConfig as JTrainerConfig
from recbox_tpu.training.packed import PackedEmbeddingTrainer as JPacked
from recbox_tpu_torch.data import ShardLoader
from recbox_tpu_torch.features import FeatureEncoder
from recbox_tpu_torch.interop import load_packed_state
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.ops.losses import binary_crossentropy
from recbox_tpu_torch.training import PackedEmbeddingTrainer, TrainerConfig

N_CAT, N_NUM, N_TOK, TOPK, DIM, HIDDEN = 4, 3, 300, 63, 8, (16, 8)
N_TRAIN, N_HELD, BATCH, ROWS_PER_SHARD = 2048, 512, 256, 300


def raw_rows(n, seed, n_cat=N_CAT, n_num=N_NUM, n_tok=N_TOK):
    """Criteo-layout rows as named columns: ``label``, ``n0..`` counts and
    ``c0..`` tokens. One token list a field (fixed seed), drawn Zipf(1.1)
    with ~3% empty; counts log-normal, rounded, ~20% NaN; the click
    Bernoulli(sigmoid(w[c0] + w[c1])), w N(0, 1) a token."""
    vocab = np.random.default_rng(99)
    toks = [np.array([f"{v:08x}" for v in vocab.integers(0, 2 ** 32, n_tok)])
            for _ in range(n_cat)]
    w = vocab.normal(size=(2, n_tok))
    rng = np.random.default_rng(seed)
    table, logit = {}, np.zeros(n)
    for f in range(n_cat):
        idx = (rng.zipf(1.1, n) - 1) % n_tok
        col = toks[f][idx].astype(object)
        col[rng.random(n) < 0.03] = ""
        table[f"c{f}"] = col
        if f < 2:
            logit += w[f, idx]
    for f in range(n_num):
        v = np.round(rng.lognormal(1.5, 1.0, n))
        v[rng.random(n) < 0.2] = np.nan
        table[f"n{f}"] = v
    table["click"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(
        np.int64)
    return table


def encoder_cols():
    return ([{"name": f"c{f}", "type": "categorical", "topk_words": TOPK,
              "embedding_dim": DIM} for f in range(N_CAT)]
            + [{"name": f"n{f}", "type": "numeric", "embedding_dim": DIM,
                "normalizer": "StandardScaler"} for f in range(N_NUM)])


def _equal_dicts(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def encoded():
    train, held = raw_rows(N_TRAIN, 0), raw_rows(N_HELD, 1)
    out = {}
    for name, cls in (("jax", JFeatureEncoder), ("port", FeatureEncoder)):
        enc = cls(encoder_cols(), label_cols=["click"], dataset_id="criteo")
        fm = enc.fit(train)
        out[name] = (fm, enc.transform(train), enc.transform(held))
    return out


def test_encoders_equal(encoded):
    jfm, jtrain, jheld = encoded["jax"]
    pfm, ptrain, pheld = encoded["port"]
    assert pfm.to_json() == jfm.to_json()
    assert [s.vocab_size for s in pfm.features[:N_CAT]] == [TOPK + 1] * N_CAT
    _equal_dicts(ptrain, jtrain)
    _equal_dicts(pheld, jheld)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_loaders_over_jax_shards_equal(encoded, tmp_path, backend):
    _, jtrain, _ = encoded["jax"]
    jsave_shards(str(tmp_path), jtrain, rows_per_shard=ROWS_PER_SHARD)
    kw = dict(batch_size=BATCH, drop_last=True, seed=3,
              reader_backend=backend)
    p = list(ShardLoader(str(tmp_path), **kw))
    j = list(JShardLoader(str(tmp_path), **kw))
    assert len(p) == len(j) == N_TRAIN // BATCH
    for a, b in zip(p, j):
        _equal_dicts(a, b)


def _recording(trainer):
    losses = []
    step = trainer.train_step

    def record(batch):
        loss = step(batch)
        losses.append(float(loss))
        return loss

    trainer.train_step = record
    return losses


def test_one_epoch_of_each_packed_trainer(encoded, tmp_path):
    jfm, jtrain, jheld = encoded["jax"]
    pfm = encoded["port"][0]
    jsave_shards(str(tmp_path), jtrain, rows_per_shard=ROWS_PER_SHARD)
    kw = dict(batch_size=BATCH, drop_last=True, seed=3,
              reader_backend="native")
    jloader, ploader = (JShardLoader(str(tmp_path), **kw),
                        ShardLoader(str(tmp_path), **kw))
    mkw = dict(embedding_dim=DIM, hidden_units=HIDDEN,
               feature_major_compute=True)
    cfg = dict(learning_rate=1e-2, epochs=1, monitor="AUC")
    jt = JPacked(JDeepFM(feature_map=jfm, **mkw),
                 lambda o, b: jbce(o, b["click"]), JTrainerConfig(**cfg))
    pt = PackedEmbeddingTrainer(
        DeepFM(pfm, device="cpu", **mkw),
        lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(**cfg), device="cpu")
    jt.init(jloader.peek_batch())
    pt.init(ploader.peek_batch())
    params = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    fnn.meta.unbox(jt.params))
    load_packed_state(pt, params,
                      {k: np.array(v) for k, v in jt.packs.items()},
                      accs={k: np.array(v) for k, v in jt.accs.items()})
    jl, pl = _recording(jt), _recording(pt)
    jt.fit(jloader)
    pt.fit(ploader)
    assert len(pl) == len(jl) == N_TRAIN // BATCH
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert np.mean(pl[-2:]) < np.mean(pl[:2])
    for name in jt.packs:
        np.testing.assert_allclose(pt.packs[name].numpy(),
                                   np.asarray(jt.packs[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    feats = {k: v for k, v in jheld.items() if k != "click"}
    np.testing.assert_allclose(pt.predict([dict(feats)]),
                               np.asarray(jt.predict([dict(feats)])),
                               rtol=1e-4, atol=1e-5)
