"""Batch iteration over dict-of-array datasets with fixed batch shapes.

Own copy of `ArrayLoader`, `MASK_KEY` and `num_batches`
(`recbox_tpu/data/loader.py:28-95`): batches are dicts of numpy arrays; the
final partial batch is either dropped or padded with a `__mask__` weight
column, so every batch has one shape. `num_samples` and `peek_batch` are
what `Trainer.fit` reads before its first epoch.

`MatchingLoader` (`loader.py:97-202`) adds the matching stage's training
batches: one negative-sampling pass an epoch (`data/sampling.py`, from a
generator seeded by the loader's own), and the item features of the
positive and its negatives as (B, 1 + num_negs, ...) ``item::`` columns,
the positive in column 0, with their ids under ``__item_ids__``. The
numpy calls are the JAX package's in its order, so both packages give the
same batches from one seed; its asserts raise ValueError here.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from recbox_tpu_torch.data.sampling import sample_negatives
from recbox_tpu_torch.features.schema import FeatureMap

__all__ = ["ArrayLoader", "MatchingLoader", "MASK_KEY", "num_batches"]

MASK_KEY = "__mask__"


def num_batches(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else math.ceil(n / batch_size)


class ArrayLoader:
    """Shuffled fixed-shape batches over a dict of equal-length arrays."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int = 2048,
                 shuffle: bool = True, drop_last: bool = False,
                 seed: int = 2024):
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"ragged columns: {lengths}")
        self.arrays = arrays
        self.n = next(iter(lengths.values()))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return num_batches(self.n, self.batch_size, self.drop_last)

    @property
    def num_samples(self) -> int:
        return self.n

    def peek_batch(self) -> Dict[str, np.ndarray]:
        """The first rows as one batch, padded to ``batch_size`` (no mask),
        without shuffling or advancing the generator: the shapes
        `Trainer.init` needs."""
        bs = min(self.batch_size, self.n)
        batch = {k: v[:bs] for k, v in self.arrays.items()}
        if bs < self.batch_size:
            pad = self.batch_size - bs
            batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                     for k, v in batch.items()}
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(idx)
        bs = self.batch_size
        stop = (self.n // bs) * bs if self.drop_last else self.n
        for start in range(0, stop, bs):
            sel = idx[start:start + bs]
            batch = {k: v[sel] for k, v in self.arrays.items()}
            if len(sel) < bs:  # pad + mask the tail batch
                pad = bs - len(sel)
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                         for k, v in batch.items()}
                mask = np.zeros(bs, dtype=np.float32)
                mask[: len(sel)] = 1.0
                batch[MASK_KEY] = mask
            else:
                batch[MASK_KEY] = np.ones(bs, dtype=np.float32)
            yield batch


class MatchingLoader(ArrayLoader):
    """Training batches for two-tower matching, negatives drawn anew each
    epoch.

    Args:
      feature_map: the schema; ``corpus_index`` names the positive item's
        column of ``train_arrays``, ``query_index`` the user's.
      train_arrays: the encoded interactions.
      corpus_arrays: the encoded item corpus; row i holds item i.
      num_negs: negatives a positive.
      sampling_probs: a per-item sampling distribution; None = uniform.
      exclude_pos: re-draw a negative equal to the row's positive.
      exclude_seen: re-draw a negative the row's user has any train
        interaction with, from a dense (users, items) bool matrix built
        here on the host (the JAX package's layout).
      exclude_ids: corpus rows that are not items (PAD / OOV): never drawn.

    The tail batch is always dropped (``drop_last``). ``peek_batch``
    samples negatives for its rows alone, from its own generator seeded
    with 0, without moving the loader's.
    """

    def __init__(
        self,
        feature_map: FeatureMap,
        train_arrays: Dict[str, np.ndarray],
        corpus_arrays: Dict[str, np.ndarray],
        batch_size: int = 2048,
        num_negs: int = 10,
        sampling_probs: Optional[np.ndarray] = None,
        exclude_pos: bool = False,
        exclude_seen: bool = False,
        shuffle: bool = True,
        seed: int = 2024,
        exclude_ids: Sequence[int] = (),
    ):
        super().__init__(train_arrays, batch_size=batch_size, shuffle=shuffle,
                         drop_last=True, seed=seed)
        self.feature_map = feature_map
        self.corpus_arrays = corpus_arrays
        self.num_negs = num_negs
        self.sampling_probs = sampling_probs
        self.exclude_pos = exclude_pos
        self.exclude_ids = tuple(exclude_ids)
        self.item_col = feature_map.corpus_index
        if self.item_col not in train_arrays:
            raise ValueError(f"train arrays missing corpus_index column "
                             f"{self.item_col!r}")
        self.num_items = len(next(iter(corpus_arrays.values())))
        self.seen_matrix = None
        self.user_col = feature_map.query_index
        if exclude_seen:
            if self.user_col not in train_arrays:
                raise ValueError("exclude_seen needs the query_index column "
                                 "in train arrays")
            users = np.asarray(train_arrays[self.user_col], np.int64)
            items = np.asarray(train_arrays[self.item_col], np.int64)
            self.seen_matrix = np.zeros(
                (int(users.max()) + 1, self.num_items), bool)
            self.seen_matrix[users, items] = True

    def _with_items(self, batch: Dict[str, np.ndarray], ids: np.ndarray
                    ) -> Dict[str, np.ndarray]:
        batch["__item_ids__"] = ids.astype(np.int32)
        for k, v in self.corpus_arrays.items():
            batch[f"item::{k}"] = v[ids]
        return batch

    def peek_batch(self) -> Dict[str, np.ndarray]:
        """The first rows as one batch with their candidate columns, their
        negatives drawn from ``default_rng(0)`` (no epoch's sampling pass,
        no shuffle)."""
        bs = min(self.batch_size, self.n)
        batch = {k: v[:bs] for k, v in self.arrays.items()}
        pos = np.asarray(batch[self.item_col], np.int64)
        negs = sample_negatives(pos, self.num_items, self.num_negs,
                                np.random.default_rng(0),
                                probs=self.sampling_probs,
                                exclude_pos=self.exclude_pos,
                                exclude_ids=self.exclude_ids)
        return self._with_items(
            batch, np.concatenate([pos[:, None], negs], axis=1))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        pos_items = self.arrays[self.item_col].astype(np.int64)
        epoch_rng = np.random.default_rng(self.rng.integers(0, 2**31))
        user_rows = (self.arrays[self.user_col].astype(np.int64)
                     if self.seen_matrix is not None else None)
        negs = sample_negatives(
            pos_items, self.num_items, self.num_negs, epoch_rng,
            probs=self.sampling_probs, exclude_pos=self.exclude_pos,
            seen_matrix=self.seen_matrix, user_rows=user_rows,
            exclude_ids=self.exclude_ids)
        item_ids = np.concatenate([pos_items[:, None], negs], axis=1)
        idx = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(idx)
        bs = self.batch_size
        for start in range(0, (self.n // bs) * bs, bs):
            sel = idx[start:start + bs]
            yield self._with_items({k: v[sel] for k, v in self.arrays.items()},
                                   item_ids[sel])
