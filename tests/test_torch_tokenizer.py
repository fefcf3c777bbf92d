"""The port's Tokenizer, Normalizer, pad_sequences and FeatureEncoder
(`recbox_tpu_torch/features/`) against the JAX package's, on the CPU.

Every case of `tests/test_tokenizer.py` runs on both packages through
`_both`, which calls the case's body once with each package's `features`
namespace and requires equal results: token ids, vocabularies, bucket ids,
normalised values and padded sequences bit for bit, feature maps as the
same JSON. The hand-computed assertions of JAX's cases then hold on the
port's result. Added: Criteo-layout columns through the native encode, the
saved files (``feature_map.json`` byte for byte, ``encoder.pkl`` loaded
across packages both ways), and the state of a Tokenizer.
"""

import os
import pickle

import numpy as np
import pytest

import recbox_tpu.features as JF
import recbox_tpu_torch.features as PF


def _same(got, want, path="out"):
    if isinstance(want, JF.FeatureMap):
        assert isinstance(got, PF.FeatureMap), path
        assert got.to_json() == want.to_json(), path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _both(fn):
    """``fn(JF)`` and ``fn(PF)`` equal; the port's result."""
    want = fn(JF)
    got = fn(PF)
    _same(got, want)
    return got


def _raises(fn, exc, match=None):
    for ns in (JF, PF):
        with pytest.raises(exc, match=match):
            fn(ns)


class TestTokenizer:
    def test_vocab_order_deterministic(self):
        vocab, size = _both(lambda F: (lambda t: (t.vocab, t.vocab_size))(
            F.Tokenizer().fit(["b", "a", "b", "c", "a", "b"])))
        assert (vocab["b"], vocab["a"], vocab["c"]) == (1, 2, 3)
        assert vocab["__OOV__"] == 0 and size == 4

    def test_oov_encoding(self):
        def run(F):
            tok = F.Tokenizer().fit(["a", "b"])
            return tok.vocab, tok.encode_category(["a", "zzz", "b", None])
        vocab, enc = _both(run)
        np.testing.assert_array_equal(enc, [vocab["a"], 0, vocab["b"], 0])

    def test_min_freq_filter(self):
        vocab, size = _both(lambda F: (lambda t: (t.vocab, t.vocab_size))(
            F.Tokenizer(min_freq=2).fit(["a", "a", "b"])))
        assert "b" not in vocab and size == 2

    def test_sequence_padding_pre(self):
        def run(F):
            tok = F.Tokenizer(splitter="^", max_len=4)
            tok.fit(["a^b^c", "b^c"], use_padding=True)
            return (tok.padding_idx, tok.vocab_size, tok.vocab,
                    tok.encode_sequence(["a^b"]))
        pad_idx, size, vocab, enc = _both(run)
        assert pad_idx == size - 1
        assert list(enc[0][:2]) == [pad_idx, pad_idx]
        assert enc[0][2] == vocab["a"]

    def test_sequence_truncation(self):
        def run(F):
            tok = F.Tokenizer(splitter="^", max_len=2, padding="post")
            tok.fit(["a^b^c^d"], use_padding=True)
            return tok.vocab, tok.encode_sequence(["a^b^c^d"])
        vocab, enc = _both(run)
        assert list(enc[0]) == [vocab["a"], vocab["b"]]

    def test_roundtrip_state(self):
        def run(F):
            tok = F.Tokenizer(splitter="^", max_len=3).fit(
                ["a^b", "b"], use_padding=True)
            tok2 = F.Tokenizer.from_state(tok.state())
            return (tok.state(), tok.encode_sequence(["a^b"]),
                    tok2.encode_sequence(["a^b"]))
        _, a, b = _both(run)
        np.testing.assert_array_equal(a, b)


class TestPadSequences:
    def test_shapes_and_values(self):
        out = _both(lambda F: F.pad_sequences([[1, 2], [3]], maxlen=3,
                                              value=9, padding="post"))
        np.testing.assert_array_equal(out, [[1, 2, 9], [3, 9, 9]])

    def test_pre_truncate_keeps_tail(self):
        out = _both(lambda F: F.pad_sequences([[1, 2, 3, 4]], maxlen=2,
                                              value=0, truncating="pre"))
        np.testing.assert_array_equal(out, [[3, 4]])


class TestNormalizer:
    def test_standard(self):
        out = _both(lambda F: F.Normalizer("StandardScaler").fit(
            np.array([1.0, 2.0, 3.0, np.nan])).transform(np.array([2.0])))
        assert abs(out[0]) < 1e-6

    def test_minmax(self):
        out = _both(lambda F: F.Normalizer("MinMaxScaler").fit(
            np.array([0.0, 10.0])).transform(np.array([5.0])))
        np.testing.assert_allclose(out, [0.5])

    def test_unknown_raises(self):
        _raises(lambda F: F.Normalizer("RobustScaler"), NotImplementedError)


def _tables():
    train = {"user_id": np.array(["u1", "u2", "u1", "u3"]),
             "item_id": np.array([0, 1, 2, 1]),
             "age": np.array([10.0, 20.0, 30.0, 40.0]),
             "click": np.array([1, 0, 1, 1])}
    corpus = {"item_id": np.arange(3), "category": np.array(["x", "y", "x"])}
    return train, corpus


class TestFeatureEncoder:
    def test_fit_transform(self):
        train, corpus = _tables()

        def run(F):
            enc = F.FeatureEncoder(
                feature_cols=[
                    {"name": "user_id", "type": "categorical",
                     "source": "user"},
                    {"name": "age", "type": "numeric", "source": "user"},
                    {"name": "category", "type": "categorical",
                     "source": "item"}],
                label_cols=["click"], dataset_id="t",
                query_index="user_id", corpus_index="item_id")
            fm = enc.fit(train, item_corpus=corpus)
            return fm, enc.transform(train), enc.transform(corpus)
        fm, arrays, item_arrays = _both(run)
        assert fm.num_items == 3 and fm["user_id"].vocab_size == 4
        assert arrays["user_id"].shape == (4,)
        assert arrays["click"].dtype == np.float32
        assert item_arrays["category"].shape == (3,)

    def test_save_load(self, tmp_path):
        train, _ = _tables()

        def run(F):
            d = str(tmp_path / F.__name__)
            enc = F.FeatureEncoder([{"name": "user_id", "type": "categorical",
                                     "source": "user"}], dataset_id="t")
            enc.fit(train)
            enc.save(d)
            return (enc.transform(train)["user_id"],
                    F.FeatureEncoder.load(d).transform(train)["user_id"])
        a, b = _both(run)
        np.testing.assert_array_equal(a, b)


class TestFeatureMap:
    def test_json_roundtrip(self, tmp_path):
        def run(F):
            fm = F.FeatureMap(
                dataset_id="d",
                features=(
                    F.FeatureSpec("uid", "categorical", "user", vocab_size=10,
                                  embedding_dim=8),
                    F.FeatureSpec("hist", "sequence", "user", vocab_size=5,
                                  embedding_dim=8, max_len=4, padding_idx=4)),
                labels=("y",), query_index="uid", num_items=5)
            p = str(tmp_path / f"{F.__name__}.json")
            fm.save(p)
            assert F.FeatureMap.load(p) == fm
            with open(p, "rb") as fh:
                return fm, fh.read()
        _both(run)

    def test_duplicate_names_rejected(self):
        _raises(lambda F: F.FeatureMap("d", (F.FeatureSpec("a"),
                                             F.FeatureSpec("a"))),
                ValueError)

    def test_sum_emb_out_dim(self):
        out = _both(lambda F: F.FeatureMap("d", (
            F.FeatureSpec("a", "categorical", vocab_size=3, embedding_dim=8),
            F.FeatureSpec("s", "sequence", vocab_size=3, embedding_dim=4,
                          max_len=5, pooling="concat"))).sum_emb_out_dim())
        assert out == 8 + 4 * 5


def test_lower_folds_case_end_to_end():
    def run(F):
        t = F.Tokenizer(lower=True)
        t.fit(["Apple", "apple", "Pear"])
        return (t.vocab, t.vocab_size, t.oov_token,
                t.encode_category(["APPLE", "pear", "unknown"]))
    vocab, size, oov, got = _both(run)
    assert size == max(vocab.values()) + 1
    assert got.tolist() == [vocab["apple"], vocab["pear"], oov]


def test_normalizer_imputes_nan_on_transform():
    out = _both(lambda F: F.Normalizer("StandardScaler").fit(
        np.array([1.0, 3.0, np.nan])).transform(np.array([np.nan, 2.0])))
    assert np.isfinite(out).all() and out[0] == 0.0


def test_share_embedding_order_independent():
    table = {"hist": np.asarray(["a^b", "c^a", "b"]),
             "item_id": np.asarray(["a", "b", "c"])}

    def run(F):
        enc = F.FeatureEncoder(
            feature_cols=[
                {"name": "hist", "type": "sequence", "splitter": "^",
                 "share_embedding": "item_id", "max_len": 3},
                {"name": "item_id", "type": "categorical"}],
            dataset_id="share_order")
        fm = enc.fit(table)
        return (fm, enc.tokenizers["hist"].vocab,
                enc.tokenizers["item_id"].vocab, enc.transform(table))
    _, hist_vocab, base_vocab, _ = _both(run)
    for tok in ("a", "b", "c"):
        assert hist_vocab[tok] == base_vocab[tok]
    _raises(lambda F: F.FeatureEncoder(feature_cols=[
        {"name": "x", "type": "categorical", "share_embedding": "nope"}],
        dataset_id="bad").fit({"x": np.asarray(["a"])}), ValueError,
        "unknown")


def _bucket_enc(F, name, kind, n, dataset_id="b"):
    return F.FeatureEncoder(
        [{"name": name, "type": "categorical", "category_encoder": kind,
          "num_buckets": n}], dataset_id=dataset_id)


class TestBucketEncoders:
    def test_quantile_bucket_balanced(self):
        vals = np.random.default_rng(0).normal(size=2000)

        def run(F):
            enc = _bucket_enc(F, "price", "quantile_bucket", 4)
            return enc.fit({"price": vals}), enc.transform(
                {"price": vals})["price"]
        fm, out = _both(run)
        assert fm["price"].vocab_size == 4 and out.dtype == np.int32
        assert out.min() == 0 and out.max() == 3
        assert np.bincount(out, minlength=4).min() > 0.8 * len(vals) / 4

    def test_quantile_bucket_monotone(self):
        def run(F):
            enc = _bucket_enc(F, "v", "quantile_bucket", 3)
            enc.fit({"v": np.arange(90, dtype=np.float64)})
            return enc.transform({"v": np.array([0.0, 40.0, 89.0])})["v"]
        out = _both(run)
        assert list(out) == sorted(out) and out[0] == 0 and out[-1] == 2

    def test_hash_bucket_stable_and_capped(self, tmp_path):
        vals = np.array(["a", "b", "c", "a", "b"])

        def run(F):
            enc = _bucket_enc(F, "tag", "hash_bucket", 100)
            fm = enc.fit({"tag": vals})
            out = enc.transform({"tag": vals})["tag"]
            d = str(tmp_path / F.__name__)
            enc.save(d)
            again = F.FeatureEncoder.load(d).transform({"tag": vals})["tag"]
            return fm, out, again
        fm, out, again = _both(run)
        assert fm["tag"].vocab_size == 3
        assert (out < 3).all() and out.dtype == np.int32
        assert out[0] == out[3] and out[1] == out[4]
        np.testing.assert_array_equal(out, again)

    def test_unknown_category_encoder_raises(self):
        _raises(lambda F: _bucket_enc(F, "x", "mystery", 4).fit(
            {"x": np.array([1.0])}), ValueError, "category_encoder")


class TestAutoEmbeddingDim:
    @pytest.mark.parametrize("vocab,dim", [(1, 8), (10_000, 64),
                                           (100_000, 112)])
    def test_rule_and_alignment(self, vocab, dim):
        assert _both(lambda F: F.auto_embedding_dim(vocab)) == dim

    def test_encoder_auto(self):
        fm = _both(lambda F: F.FeatureEncoder(
            [{"name": "item", "type": "categorical", "embedding_dim": "auto"}],
            dataset_id="auto").fit({"item": np.arange(5000).astype(str)}))
        assert fm["item"].embedding_dim \
            == PF.auto_embedding_dim(fm["item"].vocab_size)
        assert fm["item"].embedding_dim % 8 == 0

    def test_numeric_auto_raises(self):
        _raises(lambda F: F.FeatureEncoder(
            [{"name": "x", "type": "numeric", "embedding_dim": "auto"}],
            dataset_id="bad").fit({"x": np.array([1.0])}), ValueError,
            "auto")


def _log1p_round(values):
    return np.log1p(np.asarray(values, dtype=np.float64)).round().astype(
        np.int64)


class TestPreprocessHook:
    def test_applied_in_fit_and_transform(self, tmp_path):
        vals = np.array([0.0, 3.0, 30.0, 300.0, 3000.0])

        def run(F):
            enc = F.FeatureEncoder(
                [{"name": "pv", "type": "categorical",
                  "preprocess": _log1p_round}], dataset_id="pp")
            fm = enc.fit({"pv": vals})
            out = enc.transform({"pv": vals})["pv"]
            d = str(tmp_path / F.__name__)
            enc.save(d)
            return fm, out, F.FeatureEncoder.load(d).transform(
                {"pv": vals})["pv"]
        fm, out, again = _both(run)
        assert fm["pv"].vocab_size == 6 and (out > 0).all()
        np.testing.assert_array_equal(out, again)


class TestBucketEdgeCases:
    def test_quantile_nan_excluded_from_fit_imputed_at_transform(self):
        vals = np.array([1.0, 2.0, np.nan, 4.0, 5.0])

        def run(F):
            enc = _bucket_enc(F, "p", "quantile_bucket", 4)
            enc.fit({"p": vals})
            kind, (boundaries, nan_bucket) = enc.bucketizers["p"]
            return boundaries, nan_bucket, enc.transform(
                {"p": np.array([1.0, np.nan, 5.0])})["p"]
        boundaries, nan_bucket, out = _both(run)
        assert np.isfinite(boundaries).all()
        assert out[0] == 0 and out[2] == 3 and out[1] == nan_bucket
        assert 0 < nan_bucket < 4

    def test_quantile_all_nan_raises(self):
        _raises(lambda F: F.FeatureEncoder(
            [{"name": "p", "type": "categorical",
              "category_encoder": "quantile_bucket"}],
            dataset_id="allnan").fit({"p": np.array([np.nan, np.nan])}),
            ValueError, "NaN")

    def test_bucket_rejects_share_embedding(self):
        _raises(lambda F: F.FeatureEncoder(
            [{"name": "item_id", "type": "categorical"},
             {"name": "ib", "type": "categorical",
              "category_encoder": "hash_bucket",
              "share_embedding": "item_id"}],
            dataset_id="conflict").fit(
            {"item_id": np.array(["a"]), "ib": np.array(["a"])}),
            ValueError, "share_embedding")

    def test_auto_dim_share_uses_base_width(self):
        fm = _both(lambda F: F.FeatureEncoder(
            [{"name": "item_id", "type": "categorical",
              "embedding_dim": "auto"},
             {"name": "hist", "type": "sequence", "splitter": "^",
              "max_len": 3, "share_embedding": "item_id",
              "embedding_dim": "auto"}],
            dataset_id="sharedim").fit(
            {"item_id": np.array(["a", "b", "c"]),
             "hist": np.array(["a^b", "c", "b^c^a"])}))
        assert fm["hist"].embedding_dim == fm["item_id"].embedding_dim

    def test_hash_vectorized_matches_shape_and_range(self):
        vals = np.array([f"tok{i}" for i in range(5000)])

        def run(F):
            enc = _bucket_enc(F, "t", "hash_bucket", 64)
            enc.fit({"t": vals})
            return (enc.transform({"t": vals})["t"],
                    enc.transform({"t": vals})["t"])
        out, again = _both(run)
        assert out.shape == vals.shape and out.dtype == np.int32
        assert out.min() >= 0 and out.max() < 64
        assert len(np.unique(out)) == 64
        np.testing.assert_array_equal(out, again)


# -- Criteo-layout columns, the native encode and the saved files ---------------

def _criteo_rows(n, seed=0, n_tok=400):
    """``n`` rows in the Criteo layout: C1..C3 tokens of 8 hex digits
    (Zipf over ``n_tok`` tokens, ~5% empty), I1..I2 log-normal counts
    rounded, ~20% NaN, a click."""
    rng = np.random.default_rng(seed)
    table = {}
    for f in range(3):
        toks = np.array([f"{v:08x}" for v in rng.integers(0, 2 ** 32, n_tok)])
        col = toks[(rng.zipf(1.1, n) - 1) % n_tok].astype(object)
        col[rng.random(n) < 0.05] = ""
        table[f"C{f + 1}"] = col
    for f in range(2):
        v = np.round(rng.lognormal(1.0, 1.2, n))
        v[rng.random(n) < 0.2] = np.nan
        table[f"I{f + 1}"] = v
    table["label"] = (rng.random(n) < 0.25).astype(np.int64)
    return table


def _criteo_encoder(F, topk=50):
    cols = [{"name": f"C{f}", "type": "categorical", "topk_words": topk,
             "embedding_dim": 8} for f in (1, 2, 3)]
    cols += [{"name": f"I{f}", "type": "numeric", "embedding_dim": 8,
              "normalizer": "StandardScaler"} for f in (1, 2)]
    return F.FeatureEncoder(cols, label_cols=["label"], dataset_id="criteo")


@pytest.mark.parametrize("n", [1000, 6000])
def test_criteo_columns_equal_jax(n):
    """At 6000 rows the categorical columns encode through the native
    library in both packages (4,096 and above), at 1000 through the dict
    loop."""
    table = _criteo_rows(n)

    def run(F):
        enc = _criteo_encoder(F)
        fm = enc.fit(table)
        return (fm, {k: t.vocab for k, t in enc.tokenizers.items()},
                enc.transform(table),
                enc.transform(_criteo_rows(n // 2, seed=1)))
    fm, vocabs, arrays, held = _both(run)
    assert fm["C1"].vocab_size == 51 and arrays["C1"].dtype == np.int32
    assert arrays["I1"].dtype == np.float32 and np.isfinite(arrays["I1"]).all()
    assert (arrays["C2"] == 0).any()          # beyond the top 50: OOV


def test_saved_files_load_across_packages(tmp_path):
    """``feature_map.json`` byte for byte; each package's ``encoder.pkl``
    loads in the other and transforms as the saver does."""
    table = _criteo_rows(3000)
    held = _criteo_rows(1500, seed=2)
    encs = {}
    for F in (JF, PF):
        enc = _criteo_encoder(F)
        enc.fit(table)
        enc.save(str(tmp_path / F.__name__))
        encs[F] = enc
    jdir, pdir = tmp_path / JF.__name__, tmp_path / PF.__name__
    assert (jdir / "feature_map.json").read_bytes() \
        == (pdir / "feature_map.json").read_bytes()
    with open(jdir / "encoder.pkl", "rb") as a, \
            open(pdir / "encoder.pkl", "rb") as b:
        _same(pickle.load(b), pickle.load(a))
    want = encs[JF].transform(held)
    for F, d in ((PF, jdir), (JF, pdir), (PF, pdir)):
        _same(F.FeatureEncoder.load(str(d)).transform(held), want)


def test_sequence_and_meta_columns_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    items = np.array([f"i{v}" for v in rng.integers(0, 40, 300)])
    hist = np.array(["^".join(f"i{v}" for v in rng.integers(
        0, 50, rng.integers(0, 7))) for _ in range(300)], dtype=object)
    table = {"item_id": items, "hist": hist,
             "gid": rng.integers(0, 5, 300), "y": rng.random(300)}

    def run(F):
        enc = F.FeatureEncoder(
            [{"name": "item_id", "type": "categorical", "embedding_dim": 8},
             {"name": "hist", "type": "sequence", "splitter": "^",
              "max_len": 5, "share_embedding": "item_id",
              "embedding_dim": 8, "padding": "post"},
             {"name": "gid", "type": "meta"}],
            label_cols=["y"], dataset_id="seq", group_id="gid")
        fm = enc.fit(table)
        d = str(tmp_path / F.__name__)
        enc.save(d)
        with open(os.path.join(d, "feature_map.json"), "rb") as fh:
            return fm, enc.transform(table), fh.read()
    fm, arrays, _ = _both(run)
    assert arrays["hist"].shape == (300, 5)
    assert fm["hist"].padding_idx == fm["item_id"].vocab_size


def test_tokenizer_pretrained_and_merge_equal_jax():
    def run(F):
        tok = F.Tokenizer(splitter="^", max_len=3).fit(
            ["a^b", "b^c", "c"], use_padding=True)
        matrix = tok.load_pretrained_embedding(
            np.array(["b", "z"]), np.arange(8, dtype=np.float32).reshape(2, 4),
            rng=np.random.default_rng(0))
        other = F.Tokenizer().fit(["q", "a", "r"])
        base = F.Tokenizer().fit(["a", "b"])
        base.merge_vocab(other)
        return (tok.vocab, tok.vocab_size, matrix, base.vocab,
                base.vocab_size, tok.state())
    vocab, size, matrix, _, _, _ = _both(run)
    assert matrix.shape == (size, 4) and (matrix[vocab["__PAD__"]] == 0).all()
    np.testing.assert_array_equal(matrix[vocab["z"]], [4, 5, 6, 7])


@pytest.mark.parametrize("kw", [
    {}, {"min_freq": 3}, {"na_value": "b"}, {"topk_words": 7},
    {"min_freq": 2, "na_value": "", "topk_words": 5}, {"lower": True},
    {"oov_token": 2}])
@pytest.mark.parametrize("use_padding", [False, True])
def test_unicode_column_vocab_equals_jax(monkeypatch, kw, use_padding):
    """A fixed-width string column (numpy 'U') is counted and ranked in
    numpy by the port (ties in count ranked by code point, empty and
    non-ascii tokens included): the vocabulary JAX's Counter loop gives;
    with ``lower`` the port keeps JAX's loop."""
    rng = np.random.default_rng(len(kw))
    pool = np.array(["a", "b", "B", "", "é", "ab", "ß", "zz", "a b", "Ω"]
                    + [f"t{i}" for i in range(30)])
    col = pool[rng.integers(0, len(pool), 500)]
    ranked = []
    orig = PF.Tokenizer._rank_unicode
    monkeypatch.setattr(PF.Tokenizer, "_rank_unicode",
                        lambda self, a: ranked.append(1) or orig(self, a))

    def run(F):
        tok = F.Tokenizer(**kw).fit(col, use_padding=use_padding)
        return tok.vocab, tok.vocab_size, tok.encode_category(col)
    _both(run)
    assert ranked == ([] if kw.get("lower") else [1])
