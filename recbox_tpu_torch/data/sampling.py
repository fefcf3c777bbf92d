"""Negative sampling on the host, one vectorized numpy draw an epoch.

Own copy of `recbox_tpu/data/sampling.py`: `AliasTable` (Walker's alias
method, O(1) draws from a discrete distribution), `popularity_distribution`
(the four strategies: 0 uniform, 1 count^0.75, 2 log(count + 1), 3 a
log-rank decay) and `sample_negatives` (uniform or alias draws, with
bounded re-draws of collisions with the row's positive, with the user's
seen items and with ids that are not real items). The numpy calls are the
JAX package's, in the same order, so one `np.random.Generator` state gives
the same arrays bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["AliasTable", "sample_negatives", "popularity_distribution"]


class AliasTable:
    """O(1) sampling from a discrete distribution (Walker's alias method)."""

    def __init__(self, probs: np.ndarray):
        probs = np.asarray(probs, dtype=np.float64)
        probs = probs / probs.sum()
        n = len(probs)
        self.n = n
        self.prob = np.zeros(n)
        self.alias = np.zeros(n, dtype=np.int64)
        scaled = probs * n
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        while small and large:
            s, l = small.pop(), large.pop()
            self.prob[s] = scaled[s]
            self.alias[s] = l
            scaled[l] = scaled[l] - (1.0 - scaled[s])
            (small if scaled[l] < 1.0 else large).append(l)
        for i in large + small:
            self.prob[i] = 1.0

    def sample(self, size, rng: np.random.Generator) -> np.ndarray:
        idx = rng.integers(0, self.n, size=size)
        accept = rng.random(size=size) < self.prob[idx]
        return np.where(accept, idx, self.alias[idx])


def popularity_distribution(item_counts: np.ndarray, strategy: int = 1
                            ) -> np.ndarray:
    """Sampling probabilities from item counts: 0 uniform, 1 count^0.75,
    2 log(count + 1) + 1e-6, 3 (log(k + 2) - log(k + 1)) / log(n + 1) over
    the popularity rank k. All zero falls back to uniform."""
    counts = np.asarray(item_counts, dtype=np.float64)
    if strategy == 1:
        p = np.power(np.maximum(counts, 0.0), 0.75)
    elif strategy == 2:
        p = np.log(np.maximum(counts, 0.0) + 1.0) + 1e-6
    elif strategy == 3:
        order = np.argsort(-counts)
        ranks = np.empty_like(order)
        ranks[order] = np.arange(len(counts))
        p = (np.log(ranks + 2.0) - np.log(ranks + 1.0)) \
            / np.log(len(counts) + 1.0)
    else:
        p = np.ones_like(counts)
    total = p.sum()
    return p / total if total > 0 else np.full_like(p, 1.0 / len(p))


def sample_negatives(
    pos_items: np.ndarray,
    num_items: int,
    num_negs: int,
    rng: np.random.Generator,
    probs: Optional[np.ndarray] = None,
    exclude_pos: bool = False,
    max_resample_rounds: int = 8,
    seen_matrix: Optional[np.ndarray] = None,
    user_rows: Optional[np.ndarray] = None,
    exclude_ids: Sequence[int] = (),
) -> np.ndarray:
    """(N, num_negs) int32 negative item ids for N positives.

    Draws uniformly over [0, num_items), or from ``probs`` through an alias
    table. ``exclude_pos`` re-draws a negative equal to the row's positive;
    ``seen_matrix`` (users, items) bool with ``user_rows`` (N,) re-draws
    one the row's user interacted with; ``exclude_ids`` are never drawn
    (their probability is zeroed, and a uniform draw that hits one is
    re-drawn). Re-draws stop after ``max_resample_rounds`` rounds; a
    collision left then stays."""
    if seen_matrix is not None and user_rows is None:
        raise ValueError("seen_matrix needs user_rows (per-row user ids)")
    n = len(pos_items)
    shape = (n, num_negs)
    excl = np.asarray(sorted(set(int(x) for x in exclude_ids)), np.int64) \
        if len(exclude_ids) else None
    if probs is None:
        negs = rng.integers(0, num_items, size=shape)
    else:
        if excl is not None:
            probs = np.asarray(probs, np.float64).copy()
            probs[excl[excl < len(probs)]] = 0.0
        table = AliasTable(probs)
        negs = table.sample(shape, rng)

    def collisions(negs):
        bad = np.zeros(shape, bool)
        if exclude_pos:
            bad |= negs == pos_items[:, None]
        if seen_matrix is not None:
            bad |= seen_matrix[user_rows[:, None], negs]
        if excl is not None:
            bad |= np.isin(negs, excl)
        return bad

    if exclude_pos or seen_matrix is not None or excl is not None:
        for _ in range(max_resample_rounds):
            bad = collisions(negs)
            k = int(bad.sum())
            if k == 0:
                break
            if probs is None:
                negs[bad] = rng.integers(0, num_items, size=k)
            else:
                negs[bad] = table.sample(k, rng)
    return negs.astype(np.int32)
