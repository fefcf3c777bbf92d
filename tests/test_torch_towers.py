"""Port towers against the JAX package: the same flax params, moved across
with `recbox_tpu_torch.interop.from_jax_params`, must encode the same
batches (f32, rtol 1e-5 / atol 1e-6: both sides are f32 matmuls over the
same numbers, differing only in summation order)."""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.models.matching import two_tower as jtt
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import _candidates, _flatten, from_jax_params
from recbox_tpu_torch.models.matching import two_tower as ptt
from recbox_tpu_torch.nn.core import MLP, get_activation
from recbox_tpu_torch.nn.embedding import FeatureEmbedding
from recbox_tpu_torch.training.trainer import is_embedding_table

RTOL, ATOL = 1e-5, 1e-6
N_USERS, N_ITEMS, N_CATS, L = 50, 40, 7, 6
DIM = 16

# (name, type, source, vocab, dim, extra) — one spec list, two packages
SPECS = {
    "youtubednn": [
        ("user_id", "categorical", "user", N_USERS, DIM, {}),
        ("hist", "sequence", "user", N_ITEMS + 1, DIM,
         dict(max_len=L, share_embedding="item_id", padding_idx=N_ITEMS)),
        ("item_id", "categorical", "item", N_ITEMS, DIM, {}),
    ],
    "dssm": [
        ("user_id", "categorical", "user", N_USERS, 8, {}),
        ("age", "numeric", "user", 0, 4, {}),
        # no padding_idx: pads with vocab_size - 1
        ("clicks", "sequence", "user", N_CATS, 8,
         dict(max_len=L, pooling="sum")),
        ("item_id", "categorical", "item", N_ITEMS, 8, {}),
        ("item_cat", "categorical", "item", N_CATS, 8,
         dict(padding_idx=0)),
        ("group", "meta", "", 0, 0, {}),
    ],
    "mf": [
        ("user_id", "categorical", "user", N_USERS, DIM, {}),
        ("user_geo", "categorical", "user", 5, DIM, {}),
        ("item_id", "categorical", "item", N_ITEMS, DIM, {}),
    ],
}


def _maps(kind):
    jf = tuple(JFeatureSpec(n, t, source=s, vocab_size=v, embedding_dim=d, **x)
               for n, t, s, v, d, x in SPECS[kind])
    pf = tuple(FeatureSpec(n, t, source=s, vocab_size=v, embedding_dim=d, **x)
               for n, t, s, v, d, x in SPECS[kind])
    return (JFeatureMap("t", jf, query_index="user_id",
                        corpus_index="item_id", num_items=N_ITEMS),
            FeatureMap("t", pf, query_index="user_id",
                       corpus_index="item_id", num_items=N_ITEMS))


def _batches(kind, rng, b=12):
    user = {"user_id": rng.integers(0, N_USERS, b).astype(np.int32)}
    item = {"item_id": rng.integers(0, N_ITEMS, b).astype(np.int32)}
    if kind == "youtubednn":
        hist = rng.integers(0, N_ITEMS, (b, L)).astype(np.int32)
        hist[:, 3:] = N_ITEMS              # pads beyond the item vocab
        hist[0, :] = N_ITEMS               # an all-pad history
        user["hist"] = hist
    elif kind == "dssm":
        user["age"] = rng.normal(size=b).astype(np.float32)
        clicks = rng.integers(0, N_CATS - 1, (b, L)).astype(np.int32)
        clicks[:, 4:] = N_CATS - 1         # the default pad id
        user["clicks"] = clicks
        cat = rng.integers(0, N_CATS, b).astype(np.int32)
        cat[:3] = 0                        # padding_idx rows
        item["item_cat"] = cat
    elif kind == "mf":
        user["user_geo"] = rng.integers(0, 5, b).astype(np.int32)
    return user, item


def _models(kind, similarity="dot"):
    jfm, pfm = _maps(kind)
    if kind == "youtubednn":
        kw = dict(embedding_dim=DIM, hidden_units=(32, DIM),
                  similarity=similarity)
        return (jtt.YoutubeDNN(feature_map=jfm, **kw),
                ptt.YoutubeDNN(pfm, device="cpu", **kw))
    if kind == "dssm":
        kw = dict(user_hidden_units=(32, DIM), item_hidden_units=(32, DIM),
                  similarity=similarity)
        return (jtt.DSSM(feature_map=jfm, **kw),
                ptt.DSSM(pfm, device="cpu", **kw))
    return (jtt.MF(feature_map=jfm, embedding_dim=DIM, similarity=similarity),
            ptt.MF(pfm, embedding_dim=DIM, similarity=similarity,
                   device="cpu"))


def _jax_params(jmodel, user, item):
    vu = jmodel.init(jax.random.PRNGKey(0), user, method=jmodel.encode_user)
    vi = jmodel.init(jax.random.PRNGKey(1), item, method=jmodel.encode_item)
    params = {**fnn.meta.unbox(vu["params"]), **fnn.meta.unbox(vi["params"])}
    return jax.tree_util.tree_map(np.asarray, params)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("kind,similarity", [
    ("youtubednn", "dot"), ("dssm", "dot"), ("mf", "dot"),
    ("youtubednn", "cosine")])
def test_towers_match_jax(kind, similarity):
    rng = np.random.default_rng(0)
    user, item = _batches(kind, rng)
    jmodel, pmodel = _models(kind, similarity)
    params = _jax_params(jmodel, user, item)
    pmodel.load_state_dict(from_jax_params({"params": params}, pmodel))
    pmodel.eval()
    with torch.no_grad():
        pu = pmodel.encode_user(_t(user)).numpy()
        pi = pmodel.encode_item(_t(item)).numpy()
    ju = np.asarray(jmodel.apply({"params": params}, user,
                                 method=jmodel.encode_user))
    ji = np.asarray(jmodel.apply({"params": params}, item,
                                 method=jmodel.encode_item))
    assert pu.shape == ju.shape and pi.shape == ji.shape
    np.testing.assert_allclose(pu, ju, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pi, ji, rtol=RTOL, atol=ATOL)


def test_training_scores_match_jax():
    """`forward` (B, 1+negs) candidate scores: extract_item_batch +
    similarity_scores against the flax __call__."""
    rng = np.random.default_rng(1)
    user, item = _batches("youtubednn", rng, b=4)
    jmodel, pmodel = _models("youtubednn", "cosine")
    params = _jax_params(jmodel, user, item)
    pmodel.load_state_dict(from_jax_params(params, pmodel))
    pmodel.eval()
    ids = rng.integers(0, N_ITEMS, (4, 3)).astype(np.int32)
    batch = {**user, "item::item_id": ids, "__item_ids__": ids}
    js = np.asarray(jmodel.apply({"params": params}, batch))
    with torch.no_grad():
        ps = pmodel(_t(batch)).numpy()
    assert ps.shape == (4, 3)
    np.testing.assert_allclose(ps, js, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["youtubednn", "dssm", "mf"])
def test_regularizer_selection_matches_jax(kind):
    """The dense Trainer's regularizers take as embedding tables the
    parameters JAX takes (a flax path component starting ``emb_``): for
    the towers, every ``.tables.`` parameter and nothing else, as
    before."""
    rng = np.random.default_rng(2)
    user, item = _batches(kind, rng)
    jmodel, pmodel = _models(kind)
    params = _jax_params(jmodel, user, item)
    target = pmodel.state_dict()
    jax_tables = set()
    for path, arr in _flatten(params):
        if any(part.startswith("emb_") for part in path):
            jax_tables.add(next(k for k, _ in _candidates(path, arr)
                                if k in target))
    port = {n for n, _ in pmodel.named_parameters()
            if is_embedding_table(n)}
    assert port == jax_tables and port
    assert port == {n for n, _ in pmodel.named_parameters()
                    if ".tables." in "." + n}


def test_shared_pad_row_lies_beyond_item_vocab():
    """`embedding.py:187-193`: the history's PAD id (= N_ITEMS) is a row of
    the shared item table, one past the item vocab, in both towers."""
    _, pmodel = _models("youtubednn")
    assert pmodel.user_embedding.tables["item_id"].shape == (N_ITEMS + 1, DIM)
    assert pmodel.item_embedding.tables["item_id"].shape == (N_ITEMS + 1, DIM)
    assert pmodel.user_embedding.out_dim == 2 * DIM


def test_from_jax_params_rejects_leftover_and_missing():
    rng = np.random.default_rng(2)
    user, item = _batches("mf", rng)
    jmodel, pmodel = _models("mf")
    params = _jax_params(jmodel, user, item)
    extra = {**params, "user_embedding": {**params["user_embedding"],
                                          "emb_nowhere": np.zeros((2, DIM))}}
    with pytest.raises(KeyError, match="does not have"):
        from_jax_params(extra, pmodel)
    short = {**params, "user_embedding": {
        k: v for k, v in params["user_embedding"].items()
        if k != "emb_user_geo"}}
    with pytest.raises(KeyError, match="without a flax counterpart"):
        from_jax_params(short, pmodel)
    odd = {**params, "item_embedding": {"kernel_x": np.zeros(3)}}
    with pytest.raises(KeyError, match="no counterpart"):
        from_jax_params(odd, pmodel)


@pytest.mark.parametrize("act", ["relu", "gelu", "tanh", "leaky_relu"])
def test_mlp_matches_flax(act):
    from recbox_tpu.nn.core import MLP as JMLP
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 9)).astype(np.float32)
    jm = JMLP(hidden_units=(12, 7), activation=act, output_dim=3)
    params = jax.tree_util.tree_map(
        np.asarray, fnn.meta.unbox(jm.init(jax.random.PRNGKey(0), x))["params"])
    pm = MLP(9, (12, 7), activation=act, output_dim=3)
    pm.load_state_dict(from_jax_params(params, pm))
    with torch.no_grad():
        out = pm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jm.apply({"params": params}, x)),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError):
        get_activation("mish")


def test_init_is_seeded_and_matches_flax_scale():
    """Explicit generators make init reproducible; the table std and the
    xavier weights follow the JAX package's initializers."""
    _, pfm = _maps("youtubednn")
    a = ptt.YoutubeDNN(pfm, embedding_dim=DIM, hidden_units=(32, DIM),
                       generator=torch.Generator().manual_seed(5),
                       device="cpu")
    b = ptt.YoutubeDNN(pfm, embedding_dim=DIM, hidden_units=(32, DIM),
                       generator=torch.Generator().manual_seed(5),
                       device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    big = FeatureEmbedding(
        FeatureMap("b", (FeatureSpec("x", vocab_size=4000, embedding_dim=64),)),
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert abs(big.tables["x"].std().item() - 1e-4) < 5e-6
    w = MLP(256, (512,), generator=torch.Generator().manual_seed(0)
            ).dense[0].weight
    # flax xavier_normal: std sqrt(2 / (fan_in + fan_out)), truncated at 2σ'
    assert abs(w.std().item() - np.sqrt(2.0 / 768)) < 2e-3
