"""Vocabulary tokenizer and numeric normalizer (host-side preprocessing).

Own copy of `recbox_tpu/features/tokenizer.py`: the same vocabularies, ids,
padding and normalised values bit for bit. A fixed-width string column
(numpy 'U') is counted and ranked in numpy, into the vocabulary JAX's
Counter loop gives; columns of 4,096 values and more encode through the
port's native library (`retrieval/native.py`).

Behavioral parity targets (re-implemented, not copied):
  - deterministic vocab order sorted by (-count, token) with OOV=0 and
    PAD=last index — reference `recbox/matching/preprocess.py:44-60`;
  - sequence split + pre/post pad/truncate — `preprocess.py:64-74`;
  - min_freq / topk_words / na_value filtering — `preprocess.py:46-55`;
  - StandardScaler / MinMaxScaler normalizers fitted ignoring NaN —
    `preprocess.py:110-123` (implemented with numpy; no sklearn dependency).

Everything here is numpy-only and runs on host during offline preprocessing;
the outputs are integer id arrays with static shapes, ready for the device.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["Tokenizer", "Normalizer", "pad_sequences"]


def pad_sequences(
    sequences: Sequence[Sequence[int]],
    maxlen: int,
    value: int = 0,
    padding: str = "pre",
    truncating: str = "pre",
    dtype=np.int32,
) -> np.ndarray:
    """Pad/truncate ragged int lists to a (N, maxlen) array (keras semantics)."""
    out = np.full((len(sequences), maxlen), value, dtype=dtype)
    for i, seq in enumerate(sequences):
        seq = list(seq)
        if not seq:
            continue
        if len(seq) > maxlen:
            seq = seq[-maxlen:] if truncating == "pre" else seq[:maxlen]
        if padding == "pre":
            out[i, maxlen - len(seq):] = seq
        else:
            out[i, : len(seq)] = seq
    return out


class Tokenizer:
    """Maps raw categorical tokens / delimited sequences to contiguous int ids.

    Index layout (identical to the reference so embeddings line up):
      0                -> __OOV__ (also the default for unseen tokens)
      1..V             -> vocabulary tokens, ordered by (-frequency, token)
      V+1 (last index) -> __PAD__ when ``use_padding`` (sequence features)
    """

    OOV = "__OOV__"
    PAD = "__PAD__"

    def __init__(
        self,
        topk_words: Optional[int] = None,
        na_value: Optional[str] = None,
        min_freq: int = 1,
        splitter: Optional[str] = None,
        lower: bool = False,
        oov_token: int = 0,
        max_len: int = 0,
        padding: str = "pre",
    ):
        self.topk_words = topk_words
        self.na_value = na_value
        self.min_freq = min_freq
        self.splitter = splitter
        self.lower = lower
        self.oov_token = oov_token
        self.max_len = max_len
        self.padding = padding
        self.use_padding: Optional[bool] = None
        self.vocab: dict = {}
        self.vocab_size = 0  # includes OOV (and PAD when present)

    # -- fitting ------------------------------------------------------------
    @staticmethod
    def _is_null(x) -> bool:
        if x is None:
            return True
        if isinstance(x, float) and np.isnan(x):
            return True
        return False

    def fit(self, values: Iterable, use_padding: bool = False) -> "Tokenizer":
        self.use_padding = use_padding
        counts: Counter = Counter()
        if self.splitter is not None:
            observed_max = 0
            for text in values:
                if self._is_null(text) or text == "":
                    continue
                parts = str(text).split(self.splitter)
                observed_max = max(observed_max, len(parts))
                counts.update(parts)
            if self.max_len == 0:
                self.max_len = observed_max
        elif (isinstance(values, np.ndarray) and values.dtype.kind == "U"
              and not self.lower
              and (self.na_value is None or isinstance(self.na_value, str))):
            # a fixed-width string column holds no nulls: counted and
            # ranked in numpy, the vocabulary JAX's Counter loop and key
            # sort give (~4x faster on a 1M-row column)
            self._rank_unicode(values)
            return self
        else:
            counts = Counter(str(v) if not self._is_null(v) else v for v in values)
        self.build_vocab(counts)
        return self

    def _rank_unicode(self, arr: np.ndarray) -> None:
        # np.unique sorts the tokens by code point, as str comparison does,
        # and a stable sort by count keeps that order within a count: the
        # (-count, token) order of `build_vocab`
        toks, counts = np.unique(arr, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        toks, counts = toks[order], counts[order]
        keep = counts >= self.min_freq
        if self.na_value is not None:
            keep &= toks != self.na_value
        self._set_vocab(toks[keep].tolist())

    def build_vocab(self, word_counts) -> None:
        if self.lower:
            # fold case BEFORE ranking: lowering after would both leave raw
            # tokens unfindable at encode time and create duplicate vocab
            # entries whose overwrite leaves index gaps (under-sized tables)
            folded: Counter = Counter()
            for token, count in word_counts.items():
                key = token.lower() if isinstance(token, str) else token
                folded[key] += count
            word_counts = folded
        items = sorted(word_counts.items(), key=lambda kv: (-kv[1], str(kv[0])))
        words: List[str] = []
        for token, count in items:
            if count < self.min_freq or self._is_null(token):
                continue
            if self.na_value is not None and token == self.na_value:
                continue
            words.append(token)
        self._set_vocab(words)

    def _set_vocab(self, words: List[str]) -> None:
        if self.topk_words:
            words = words[: self.topk_words]
        self.vocab = {tok: idx for idx, tok in enumerate(words, 1 + self.oov_token)}
        self.vocab[self.OOV] = self.oov_token
        if self.use_padding:
            self.vocab[self.PAD] = len(words) + self.oov_token + 1
        self.vocab_size = len(self.vocab) + self.oov_token

    def merge_vocab(self, other: "Tokenizer") -> None:
        """Union another tokenizer's vocab into this one (shared embeddings)."""
        for tok in other.vocab:
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
        self.vocab_size = len(self.vocab) + self.oov_token

    @property
    def padding_idx(self) -> Optional[int]:
        return self.vocab.get(self.PAD)

    # -- encoding -----------------------------------------------------------
    def encode_category(self, values: Iterable) -> np.ndarray:
        # native fast path: fixed-width byte hashing in C++ — the Python
        # dict loop runs ~1M vals/s, and numpy searchsorted over string
        # arrays measures 2x SLOWER than the loop, so vocab lookup at
        # Criteo scale is a genuine native-kernel case (retrieval/native.py)
        arr = np.asarray(values if not hasattr(values, "values")
                         else values.values)
        # null mask comes from the ORIGINAL dtype — lowering rebinds arr to
        # 'U', where None/NaN have already become the literal tokens
        # 'none'/'nan' and would match real vocab entries
        null = None
        if arr.dtype == object or arr.dtype.kind == "f":
            null = np.asarray([self._is_null(v) for v in arr], bool)
        if self.lower:
            arr = np.char.lower(arr.astype("U"))
        if len(arr) >= 4096:
            from recbox_tpu_torch.retrieval.native import vocab_encode_native
            out = vocab_encode_native(arr, self.vocab, self.oov_token)
            if out is not None:
                if null is not None and null.any():
                    out = np.where(null, self.oov_token, out)
                return out.astype(np.int32)
        get = self.vocab.get
        oov = self.oov_token
        out = np.asarray(
            [oov if self._is_null(v) else get(str(v), oov) for v in arr],
            dtype=np.int32,
        )
        if null is not None and null.any():   # lowered arr hides nulls
            out = np.where(null, oov, out).astype(np.int32)
        return out

    def encode_sequence(self, texts: Iterable) -> np.ndarray:
        assert self.splitter is not None, "encode_sequence needs a splitter"
        seqs: List[List[int]] = []
        get = self.vocab.get
        oov = self.oov_token
        for text in texts:
            if self._is_null(text) or text == "":
                seqs.append([])
            else:
                parts = str(text).split(self.splitter)
                if self.lower:
                    parts = [t.lower() for t in parts]
                seqs.append([get(t, oov) for t in parts])
        pad_value = self.padding_idx if self.padding_idx is not None else self.vocab_size - 1
        return pad_sequences(
            seqs, maxlen=self.max_len, value=pad_value,
            padding=self.padding, truncating=self.padding,
        )

    # -- pretrained embeddings ---------------------------------------------
    def load_pretrained_embedding(
        self, keys: np.ndarray, values: np.ndarray, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        """Merge a pretrained (keys, values) table into the vocab; return matrix.

        New tokens from the pretrained vocab are appended (so val/test-only ids
        resolve); PAD stays the all-zero last row. Un-pretrained rows are
        normal(0, 1e-4) like the reference (`preprocess.py:88-99`).
        """
        rng = rng or np.random.default_rng(0)
        pre_vocab = {str(k): i for i, k in enumerate(keys)}
        had_pad = self.PAD in self.vocab
        if had_pad:
            del self.vocab[self.PAD]
        for tok in pre_vocab:
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
        if had_pad:
            self.vocab[self.PAD] = len(self.vocab)
        self.vocab_size = len(self.vocab) + self.oov_token
        dim = values.shape[1]
        matrix = rng.normal(0.0, 1e-4, size=(self.vocab_size, dim))
        for tok, row in pre_vocab.items():
            matrix[self.vocab[tok]] = values[row]
        if had_pad:
            matrix[self.vocab[self.PAD]] = 0.0
        return matrix.astype(np.float32)

    # -- persistence --------------------------------------------------------
    def state(self) -> dict:
        # every encode-time flag must persist: a reloaded tokenizer that
        # dropped `lower` (case-folding) or `na_value` would resolve
        # tokens differently at serve than at fit
        return {
            "vocab": self.vocab,
            "vocab_size": self.vocab_size,
            "max_len": self.max_len,
            "splitter": self.splitter,
            "padding": self.padding,
            "oov_token": self.oov_token,
            "use_padding": self.use_padding,
            "lower": self.lower,
            "na_value": self.na_value,
        }

    @classmethod
    def from_state(cls, st: dict) -> "Tokenizer":
        tok = cls(splitter=st.get("splitter"), oov_token=st.get("oov_token", 0),
                  max_len=st.get("max_len", 0), padding=st.get("padding", "pre"),
                  lower=st.get("lower", False), na_value=st.get("na_value"))
        tok.vocab = dict(st["vocab"])
        tok.vocab_size = st["vocab_size"]
        tok.use_padding = st.get("use_padding")
        return tok


class Normalizer:
    """NaN-aware standard or min-max scaler for numeric columns (numpy-only)."""

    def __init__(self, kind: str = "StandardScaler"):
        if kind not in ("StandardScaler", "MinMaxScaler"):
            raise NotImplementedError(f"normalizer={kind}")
        self.kind = kind
        self.mean_ = 0.0
        self.scale_ = 1.0
        self.min_ = 0.0

    def fit(self, x: np.ndarray) -> "Normalizer":
        x = np.asarray(x, dtype=np.float64)
        valid = x[~np.isnan(x)]
        if valid.size == 0:
            return self
        if self.kind == "StandardScaler":
            self.mean_ = float(valid.mean())
            std = float(valid.std())
            self.scale_ = std if std > 0 else 1.0
        else:
            lo, hi = float(valid.min()), float(valid.max())
            self.min_ = lo
            self.mean_ = lo
            self.scale_ = (hi - lo) if hi > lo else 1.0
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        out = ((x - self.mean_) / self.scale_).astype(np.float32)
        # missing values impute to the fitted center (0 after standardizing,
        # the min after min-max) — NaN would otherwise reach the model and
        # NaN the loss (fit already ignores NaN; transform must too)
        return np.where(np.isnan(out), np.float32(0.0), out)

    def state(self) -> dict:
        return {"kind": self.kind, "mean": self.mean_, "scale": self.scale_}

    @classmethod
    def from_state(cls, st: dict) -> "Normalizer":
        n = cls(st["kind"])
        n.mean_, n.scale_ = st["mean"], st["scale"]
        return n
