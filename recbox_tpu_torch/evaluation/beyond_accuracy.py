"""Beyond-accuracy recommendation metrics.

Own copy of `recbox_tpu/evaluation/beyond_accuracy.py` (recbole's
ItemCoverage, AveragePopularity, ShannonEntropy, GiniIndex, TailPercentage
and daisy's Diversity): numpy reductions over the recommended top-k id
matrix (U, K) and the corpus' statistics, on the host, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["item_coverage", "average_popularity", "shannon_entropy",
           "gini_index", "tail_percentage", "diversity",
           "evaluate_beyond_accuracy"]


def item_coverage(topk_items: np.ndarray, num_items: int) -> float:
    """Fraction of the catalog that appears in any user's top-k
    (`metrics.py` ItemCoverage)."""
    return len(np.unique(topk_items)) / float(num_items)


def average_popularity(topk_items: np.ndarray,
                       item_counts: np.ndarray) -> float:
    """Mean training-interaction count of recommended items
    (`metrics.py` AveragePopularity) — lower = less popularity bias."""
    pops = item_counts[np.clip(topk_items, 0, len(item_counts) - 1)]
    return float(np.mean(pops))


def shannon_entropy(topk_items: np.ndarray) -> float:
    """Entropy of the recommended-item distribution, normalized by the
    number of distinct recommended items (`metrics.py` ShannonEntropy
    `get_entropy`: ``result / len(item_count)``) — higher = more diverse."""
    _, counts = np.unique(topk_items, return_counts=True)
    p = counts / counts.sum()
    return float(-np.sum(p * np.log(p)) / len(counts))


def gini_index(topk_items: np.ndarray, num_items: int) -> float:
    """Gini of recommendation exposure over the catalog
    (`metrics.py` GiniIndex) — 0 = perfectly even exposure."""
    counts = np.bincount(topk_items.reshape(-1), minlength=num_items)
    sorted_counts = np.sort(counts)
    n = num_items
    idx = np.arange(1, n + 1)
    total = sorted_counts.sum()
    if total == 0:
        return 0.0
    return float(np.sum((2 * idx - n - 1) * sorted_counts) / (n * total))


def tail_percentage(topk_items: np.ndarray, item_counts: np.ndarray,
                    tail_ratio: float = 0.1) -> float:
    """Share of recommended items from the long tail — the least-popular
    `tail_ratio` of the items THAT APPEAR IN TRAINING DATA
    (`metrics.py` TailPercentage `get_tail`: candidates come from
    ``count_items``, i.e. observed items only — never-interacted catalog
    items and padding are not tail candidates). Ties broken by
    (count, item id) like the reference's stable sorted() over dict items."""
    item_counts = np.asarray(item_counts)
    observed = np.flatnonzero(item_counts > 0)
    if len(observed) == 0:
        return 0.0
    # lexsort: primary key counts, secondary key item id (reference iterates
    # dict items in id order before the stable count sort)
    order = observed[np.lexsort((observed, item_counts[observed]))]
    n_tail = max(1, int(len(observed) * tail_ratio))
    tail = np.zeros(len(item_counts), bool)
    tail[order[:n_tail]] = True
    flat = np.clip(topk_items.reshape(-1), 0, len(item_counts) - 1)
    return float(np.mean(tail[flat]))


def diversity(topk_items: np.ndarray,
              item_categories: np.ndarray) -> float:
    """Intra-list diversity: mean pairwise Euclidean distance between the
    category vectors of each user's recommended items, averaged over users
    (daisy `utils/metrics.py:125-148` Diversity — vectorized via the Gram
    matrix instead of the O(U·K²) Python loops).

    item_categories: (num_items, num_categories) 0/1 matrix.
    """
    topk_items = np.asarray(topk_items)
    cats = np.asarray(item_categories, dtype=np.float64)
    U, K = topk_items.shape
    if K < 2:
        return 0.0
    valid = (topk_items >= 0) & (topk_items < len(cats))   # pad slots drop
    c = cats[np.clip(topk_items, 0, len(cats) - 1)]        # (U, K, C)
    sq = np.sum(c * c, axis=-1)                            # (U, K)
    gram = np.einsum("ukc,ulc->ukl", c, c)                 # (U, K, K)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
    d = np.sqrt(np.maximum(d2, 0.0))
    iu = np.triu_indices(K, k=1)
    pair_ok = (valid[:, iu[0]] & valid[:, iu[1]]).astype(np.float64)
    n_pairs = pair_ok.sum(axis=1)
    per_user = np.where(n_pairs > 0,
                        (d[:, iu[0], iu[1]] * pair_ok).sum(axis=1)
                        / np.maximum(n_pairs, 1.0), 0.0)
    keep = n_pairs > 0
    return float(per_user[keep].mean()) if keep.any() else 0.0


def evaluate_beyond_accuracy(
        topk_items: np.ndarray, num_items: int,
        item_counts: Optional[np.ndarray] = None,
        metrics: Sequence[str] = ("ItemCoverage", "ShannonEntropy",
                                  "GiniIndex"),
        tail_ratio: float = 0.1,
        item_categories: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Dispatch over the beyond-accuracy metric names (recbole spelling).

    Slots outside [0, num_items) are PADDING (candidate-protocol lists
    shorter than k carry out-of-catalog ids) and are dropped before any
    counting — coverage/entropy/Gini must describe real recommendations
    only, and a bincount over a pad id >= num_items would crash Gini.
    """
    topk_items = np.asarray(topk_items)
    valid = (topk_items >= 0) & (topk_items < num_items)
    if valid.all():
        counted = topk_items
    else:
        # count-based metrics see the valid multiset only; Diversity is
        # per-row and masks pad slots internally
        counted = topk_items[valid].reshape(1, -1)
    out: Dict[str, float] = {}
    for m in metrics:
        key = m.lower()
        if key == "itemcoverage":
            out[m] = item_coverage(counted, num_items)
        elif key == "averagepopularity":
            if item_counts is None:
                raise ValueError("AveragePopularity needs item_counts")
            out[m] = average_popularity(counted, item_counts)
        elif key == "shannonentropy":
            out[m] = shannon_entropy(counted)
        elif key == "giniindex":
            out[m] = gini_index(counted, num_items)
        elif key == "tailpercentage":
            if item_counts is None:
                raise ValueError("TailPercentage needs item_counts")
            out[m] = tail_percentage(counted, item_counts, tail_ratio)
        elif key == "diversity":
            if item_categories is None:
                raise ValueError("Diversity needs item_categories")
            out[m] = diversity(topk_items, item_categories)
        else:
            raise NotImplementedError(f"unknown beyond-accuracy metric {m}")
    return out
