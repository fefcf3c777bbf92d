"""CTR metrics: exact AUC (ties share their average rank) and log loss.

Own copy of `recbox_tpu/evaluation/ctr.py` `_average_ranks`, `auc_score`
and `log_loss` (:30-64), numpy only. `auc_jax`, grouped AUC and the
`CTREvaluator` are not ported yet (`ROADMAP.md`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["auc_score", "log_loss"]


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties sharing their average rank."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    boundary = np.ones(len(x), dtype=bool)
    boundary[1:] = sx[1:] != sx[:-1]
    run_ids = np.cumsum(boundary) - 1
    idx = np.arange(1, len(x) + 1, dtype=np.float64)
    sums = np.zeros(run_ids[-1] + 1 if len(x) else 0)
    counts = np.zeros_like(sums)
    np.add.at(sums, run_ids, idx)
    np.add.at(counts, run_ids, 1.0)
    ranks[order] = (sums / counts)[run_ids]
    return ranks


def auc_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1).astype(np.float64)
    n_pos = float(np.sum(y_true > 0))
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC undefined with a single class")
    ranks = _average_ranks(y_pred)
    return float((np.sum(ranks[y_true > 0]) - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def log_loss(y_true: np.ndarray, y_pred: np.ndarray,
             eps: float = 1e-7) -> float:
    y_true = np.asarray(y_true, dtype=np.float64).reshape(-1)
    p = np.clip(np.asarray(y_pred, dtype=np.float64).reshape(-1), eps,
                1 - eps)
    return float(-np.mean(y_true * np.log(p) + (1 - y_true) * np.log(1 - p)))
