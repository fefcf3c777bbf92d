"""Batch iteration over dict-of-array datasets with fixed batch shapes.

Own copy of `ArrayLoader` and `MASK_KEY` (`recbox_tpu/data/loader.py:28-95`):
batches are dicts of numpy arrays; the final partial batch is either dropped
or padded with a `__mask__` weight column, so every batch has one shape.
`MatchingLoader` (negative sampling for training) waits for the training
slice.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator

import numpy as np

__all__ = ["ArrayLoader", "MASK_KEY"]

MASK_KEY = "__mask__"


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
        return self.n // self.batch_size if self.drop_last \
            else math.ceil(self.n / self.batch_size)

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
