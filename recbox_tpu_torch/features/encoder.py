"""FeatureEncoder: fit tokenizers/normalizers from tabular data, emit arrays.

Own copy of `recbox_tpu/features/encoder.py`. ``save`` writes JAX's files
(``feature_map.json`` byte for byte, ``encoder.pkl`` of builtins and numpy
arrays), so a directory either package saved loads in the other; a
``preprocess`` callable pickles by its module path.

Unified re-design of the reference's two near-duplicate preprocessors
(`recbox/matching/features.py:61-328` FeatureEncoder and
`recbox/ranking/preprocess/feature_processor.py:32-335` FeatureProcessor):
one encoder serves both the matching stage (with an item corpus joined on
``corpus_index``) and the ranking stage (flat labeled rows).

Feature column configs are dicts in the same spirit as the reference YAMLs:

    {"name": "user_id", "type": "categorical", "source": "user"}
    {"name": "age",     "type": "numeric", "normalizer": "StandardScaler"}
    {"name": "hist",    "type": "sequence", "splitter": "^", "max_len": 20,
     "share_embedding": "item_id"}

`fit` builds deterministic vocabularies; `transform` maps a table to a dict of
static-shape numpy arrays (the batch layout consumed by every model).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from recbox_tpu_torch.features.schema import (
    CATEGORICAL, META, NUMERIC, SEQUENCE, FeatureMap, FeatureSpec,
    auto_embedding_dim,
)
from recbox_tpu_torch.features.tokenizer import Normalizer, Tokenizer

__all__ = ["FeatureEncoder"]


def _get_column(table, name: str) -> np.ndarray:
    """Extract a column from a pandas DataFrame or a mapping of arrays."""
    if hasattr(table, "columns"):  # pandas
        return table[name].values
    return np.asarray(table[name])


class FeatureEncoder:
    """Fits per-feature encoders and materializes model-ready arrays."""

    def __init__(
        self,
        feature_cols: Sequence[dict],
        label_cols: Sequence[str] = (),
        dataset_id: str = "dataset",
        query_index: str = "",
        corpus_index: str = "",
        group_id: str = "",
        default_embedding_dim: int = 16,
        data_root: str = "./data",
    ):
        # flatten nested groups (the reference YAML allows a list of lists
        # with shared attrs, `feature_processor.py:41-48`)
        flat: List[dict] = []
        for col in feature_cols:
            if isinstance(col.get("name"), (list, tuple)):
                for n in col["name"]:
                    c = dict(col)
                    c["name"] = n
                    flat.append(c)
            else:
                flat.append(dict(col))
        self.feature_cols = flat
        self.label_cols = list(label_cols)
        self.dataset_id = dataset_id
        self.query_index = query_index
        self.corpus_index = corpus_index
        self.group_id = group_id
        self.default_embedding_dim = default_embedding_dim
        self.data_root = data_root
        self.tokenizers: Dict[str, Tokenizer] = {}
        self.normalizers: Dict[str, Normalizer] = {}
        # name -> ("quantile", boundaries ndarray) | ("hash", num_buckets)
        self.bucketizers: Dict[str, tuple] = {}
        # per-column raw-value hook applied before fit AND transform — the
        # reference's regex-parsed "fn(arg)" preprocess strings resolved to
        # FeatureProcessor subclass methods (`feature_processor.py:82-88`);
        # a plain callable is the idiomatic form here. Must be a module-level
        # function (not a lambda) for the encoder to survive save()/load().
        self._preprocess = {c["name"]: c["preprocess"]
                            for c in flat if callable(c.get("preprocess"))}
        self.feature_map: Optional[FeatureMap] = None

    # -- fit ----------------------------------------------------------------
    def fit(self, train_table, item_corpus=None, min_categr_count: int = 1) -> FeatureMap:
        """Fit encoders from the training table (and optional item corpus).

        For matching datasets, features with source=='item' are fitted from
        ``item_corpus`` and the corpus_index column becomes the item-id space
        (reference join semantics: `recbox/matching/features.py:105-156`).
        """
        spec_by_name: Dict[str, FeatureSpec] = {}
        auto_dims: set = set()
        num_items = 0
        # process share_embedding columns AFTER their base columns so the
        # shared vocab exists when they fit, and SEQUENCE share columns
        # after categorical shares: a sequence share snapshots the base
        # vocab (its PAD id = final vocab_size), so every categorical
        # merge_vocab must have grown the base first — otherwise tokens
        # added later encode to OOV in the sequence column and its PAD id
        # aliases a live row of the shared table
        order = sorted(
            self.feature_cols,
            key=lambda c: (bool(c.get("share_embedding")),
                           bool(c.get("share_embedding"))
                           and c.get("type", CATEGORICAL) == SEQUENCE))
        for col in order:
            name = col["name"]
            share_target = col.get("share_embedding")
            if share_target and share_target not in {
                    c["name"] for c in self.feature_cols}:
                raise ValueError(
                    f"feature {name!r} shares embedding with unknown "
                    f"column {share_target!r}")
            ftype = col.get("type", CATEGORICAL)
            source = col.get("source", "")
            table = item_corpus if (item_corpus is not None and source == "item") else train_table
            values = _get_column(table, name)
            if name in self._preprocess:
                values = np.asarray(self._preprocess[name](values))
            emb_dim = col.get("embedding_dim", self.default_embedding_dim)
            if emb_dim == "auto":
                # resolved from the final vocab size in the assembly pass
                # below (vocabs can still grow through share_embedding
                # merges); rechub's 6·⌈vocab^0.25⌉ rule, `utils/data.py:85-97`
                auto_dims.add(name)
                emb_dim = 0

            if ftype == META:
                spec_by_name[name] = FeatureSpec(name=name, type=META, source=source)
                continue
            if ftype == NUMERIC:
                if name in auto_dims:
                    raise ValueError(
                        f"embedding_dim='auto' needs a vocabulary; numeric "
                        f"feature {name!r} must set an explicit width")
                norm = Normalizer(col.get("normalizer", "StandardScaler"))
                norm.fit(values)
                self.normalizers[name] = norm
                spec_by_name[name] = FeatureSpec(
                    name=name, type=NUMERIC, source=source,
                    embedding_dim=emb_dim)
                continue

            share = col.get("share_embedding")
            if ftype == CATEGORICAL and col.get("category_encoder"):
                # bucketized categorical columns — reference declares these
                # (`recbox/matching/features.py:219-237`) but its transform
                # raises NotImplementedError (`features.py:292-298`); here
                # both directions work.
                incompatible = [k for k in ("share_embedding", "pretrained_emb",
                                            "na_value", "topk_words",
                                            "min_categr_count") if k in col]
                if incompatible:
                    raise ValueError(
                        f"feature {name!r}: category_encoder cannot combine "
                        f"with {incompatible} (buckets have no token vocab "
                        "to share, pretrain, or frequency-filter)")
                enc_kind = col["category_encoder"]
                num_buckets = int(col.get("num_buckets", 10))
                if enc_kind == "quantile_bucket":
                    vals = np.asarray(values, dtype=np.float64)
                    if np.isnan(vals).all():
                        raise ValueError(
                            f"quantile_bucket feature {name!r}: all values "
                            "NaN at fit")
                    # boundaries = the reference's
                    # QuantileTransformer(n_quantiles=B+1).quantiles_[1:-1]:
                    # B-1 internal quantile cut points. NaNs are excluded
                    # from the fit and imputed to the median bucket at
                    # transform (the Normalizer's mean-imputation policy;
                    # plain np.quantile would yield all-NaN boundaries and
                    # silently collapse every value into the top bucket).
                    qs = np.linspace(0.0, 1.0, num_buckets + 1)[1:-1]
                    boundaries = np.nanquantile(vals, qs)
                    nan_bucket = int(np.digitize(np.nanmedian(vals),
                                                 boundaries))
                    self.bucketizers[name] = ("quantile",
                                              (boundaries, nan_bucket))
                    vocab = num_buckets
                elif enc_kind == "hash_bucket":
                    n_unique = len(np.unique(np.asarray(values).astype(str)))
                    vocab = min(num_buckets, n_unique)
                    self.bucketizers[name] = ("hash", vocab)
                else:
                    raise ValueError(
                        f"category_encoder={enc_kind!r} not supported "
                        "(use 'quantile_bucket' or 'hash_bucket')")
                spec_by_name[name] = FeatureSpec(
                    name=name, type=CATEGORICAL, source=source,
                    vocab_size=vocab, embedding_dim=emb_dim)
                continue
            if ftype == CATEGORICAL:
                if share and share not in self.tokenizers:
                    # the target exists but has no token vocab (bucketized
                    # or numeric column): sharing its table would mix two
                    # unrelated id spaces onto the same rows
                    raise ValueError(
                        f"feature {name!r}: share_embedding target "
                        f"{share!r} has no token vocabulary (bucketized/"
                        "numeric columns cannot share embeddings)")
                if share:
                    tok = self.tokenizers[share]
                    # grow shared vocab with this column's tokens
                    aux = Tokenizer(min_freq=col.get("min_categr_count", min_categr_count),
                                    na_value=col.get("na_value"))
                    aux.fit(values, use_padding=False)
                    tok.merge_vocab(aux)
                else:
                    tok = Tokenizer(
                        min_freq=col.get("min_categr_count", min_categr_count),
                        na_value=col.get("na_value"),
                        topk_words=col.get("topk_words"),
                    )
                    tok.fit(values, use_padding=False)
                self.tokenizers[name] = tok
                spec_by_name[name] = FeatureSpec(
                    name=name, type=CATEGORICAL, source=source,
                    vocab_size=tok.vocab_size, embedding_dim=emb_dim,
                    share_embedding=share)
            elif ftype == SEQUENCE:
                tok = Tokenizer(
                    min_freq=col.get("min_categr_count", min_categr_count),
                    na_value=col.get("na_value"),
                    splitter=col.get("splitter", "^"),
                    max_len=col.get("max_len", 0),
                    padding=col.get("padding", "pre"),
                )
                tok.fit(values, use_padding=True)
                if share and share not in self.tokenizers:
                    raise ValueError(
                        f"feature {name!r}: share_embedding target "
                        f"{share!r} has no token vocabulary (bucketized/"
                        "numeric columns cannot share embeddings)")
                if share:
                    base = self.tokenizers[share]
                    # share the table: sequence ids must live in the base
                    # vocab; PAD maps to base vocab_size (extra zero row).
                    tok.vocab = dict(base.vocab)
                    tok.vocab[Tokenizer.PAD] = base.vocab_size
                    tok.vocab_size = base.vocab_size + 1
                self.tokenizers[name] = tok
                spec_by_name[name] = FeatureSpec(
                    name=name, type=SEQUENCE, source=source,
                    vocab_size=tok.vocab_size, embedding_dim=emb_dim,
                    max_len=tok.max_len, share_embedding=share,
                    padding_idx=tok.padding_idx,
                    pooling=col.get("pooling", "mean"))
            else:
                raise ValueError(f"unknown feature type {ftype!r} for {name}")

        # assemble specs in the DECLARED column order (processing order was
        # share-last); vocab growth through merges needs a final pass
        specs = [spec_by_name[c["name"]] for c in self.feature_cols]
        fixed: List[FeatureSpec] = []
        for s in specs:
            if s.name in self.tokenizers:
                tok = self.tokenizers[s.name]
                s = FeatureSpec(**{**s.__dict__, "vocab_size": tok.vocab_size,
                                   "padding_idx": tok.padding_idx})
            if s.name in auto_dims and not s.share_embedding:
                s = FeatureSpec(**{**s.__dict__,
                                   "embedding_dim": auto_embedding_dim(s.vocab_size)})
            fixed.append(s)
        # share_embedding columns must match the BASE table's width — an
        # auto dim derived from their own vocab (base+1 for sequence PAD)
        # would silently size the shared table inconsistently
        by_name = {s.name: s for s in fixed}
        specs = [s if not (s.name in auto_dims and s.share_embedding)
                 else FeatureSpec(**{**s.__dict__, "embedding_dim":
                                     by_name[s.share_embedding].embedding_dim})
                 for s in fixed]

        if item_corpus is not None and self.corpus_index:
            num_items = len(_get_column(item_corpus, self.corpus_index))

        self.feature_map = FeatureMap(
            dataset_id=self.dataset_id,
            features=tuple(specs),
            labels=tuple(self.label_cols),
            query_index=self.query_index,
            corpus_index=self.corpus_index,
            group_id=self.group_id,
            num_items=num_items,
        )
        return self.feature_map

    # -- transform ----------------------------------------------------------
    def transform(self, table, columns: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """Encode a table into {name: int32/float32 array} with static shapes."""
        assert self.feature_map is not None, "call fit() first"
        out: Dict[str, np.ndarray] = {}
        wanted = set(columns) if columns is not None else None
        for spec in self.feature_map.features:
            if wanted is not None and spec.name not in wanted:
                continue
            if not self._has_column(table, spec.name):
                continue
            values = _get_column(table, spec.name)
            if spec.name in self._preprocess:
                values = np.asarray(self._preprocess[spec.name](values))
            if spec.type == META:
                out[spec.name] = np.asarray(values)
            elif spec.type == NUMERIC:
                out[spec.name] = self.normalizers[spec.name].transform(values)
            elif spec.type == CATEGORICAL:
                if spec.name in self.bucketizers:
                    out[spec.name] = self._bucketize(spec.name, values)
                else:
                    out[spec.name] = self.tokenizers[spec.name].encode_category(values)
            elif spec.type == SEQUENCE:
                out[spec.name] = self.tokenizers[spec.name].encode_sequence(values)
        for label in self.label_cols:
            if self._has_column(table, label):
                out[label] = np.asarray(_get_column(table, label), dtype=np.float32)
        return out

    def _bucketize(self, name: str, values) -> np.ndarray:
        kind, arg = self.bucketizers[name]
        if kind == "quantile":
            boundaries, nan_bucket = arg
            vals = np.asarray(values, dtype=np.float64)
            out = np.digitize(vals, boundaries).astype(np.int32)
            # serve-time NaNs go to the fitted median's bucket (digitize
            # would silently put them in the TOP bucket)
            return np.where(np.isnan(vals), np.int32(nan_bucket), out)
        # hash: deterministic so encodings are stable across processes —
        # python's builtin hash() is per-process salted and would scramble
        # ids between train and serve. Vectorized FNV-1a over the
        # fixed-width byte matrix (a per-element Python hash loop runs
        # ~1M vals/s — minutes per transform at Criteo scale).
        arr = np.asarray(values)
        try:
            flat = arr.astype("S")                     # (N,) fixed-width bytes
        except UnicodeEncodeError:
            # astype('S') is a strict ASCII cast; non-ASCII categories
            # ('münchen', 'café') that fit() accepted must encode too —
            # same utf-8 fallback as the native encoder's to_bytes
            flat = np.char.encode(arr.astype(str), "utf-8")
        byte_mat = flat.view(np.uint8).reshape(len(flat), -1)  # (N, W)
        h = np.full(len(flat), np.uint64(0xCBF29CE484222325))
        prime = np.uint64(0x100000001B3)
        for c in range(byte_mat.shape[1]):
            col = byte_mat[:, c].astype(np.uint64)
            # pad bytes (0) leave the hash untouched so "a" and "a\0\0"
            # collide as they should; branchless where beats fancy indexing
            h = np.where(col != 0, (h ^ col) * prime, h)
        return (h % np.uint64(arg)).astype(np.int32).reshape(np.shape(values))

    @staticmethod
    def _has_column(table, name: str) -> bool:
        if hasattr(table, "columns"):
            return name in table.columns
        return name in table

    # -- persistence --------------------------------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        assert self.feature_map is not None
        self.feature_map.save(os.path.join(directory, "feature_map.json"))
        state = {
            "tokenizers": {k: t.state() for k, t in self.tokenizers.items()},
            "normalizers": {k: n.state() for k, n in self.normalizers.items()},
            "bucketizers": self.bucketizers,
            "feature_cols": self.feature_cols,
            "label_cols": self.label_cols,
        }
        with open(os.path.join(directory, "encoder.pkl"), "wb") as fh:
            pickle.dump(state, fh)

    @classmethod
    def load(cls, directory: str) -> "FeatureEncoder":
        with open(os.path.join(directory, "encoder.pkl"), "rb") as fh:
            state = pickle.load(fh)
        fm = FeatureMap.load(os.path.join(directory, "feature_map.json"))
        enc = cls(state["feature_cols"], state["label_cols"], dataset_id=fm.dataset_id,
                  query_index=fm.query_index, corpus_index=fm.corpus_index,
                  group_id=fm.group_id)
        enc.tokenizers = {k: Tokenizer.from_state(s) for k, s in state["tokenizers"].items()}
        enc.normalizers = {k: Normalizer.from_state(s) for k, s in state["normalizers"].items()}
        enc.bucketizers = state.get("bucketizers", {})
        enc.feature_map = fm
        return enc
