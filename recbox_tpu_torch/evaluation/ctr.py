"""CTR evaluation: AUC / logloss / ACC / MAE / RMSE / gAUC / avgAUC / MRR /
NDCG@k.

Counterpart of `recbox_tpu/evaluation/ctr.py`: the exact AUC (ties share
their average rank), log loss and the value metrics in numpy on the host;
the grouped metrics in one pass of sorts on the device
(`evaluation/grouped.py`), with the host loop of `grouped_auc` / `_mrr` /
`_ndcg` kept as their reference; and `auc_torch`, the counterpart of
`auc_jax`, a histogram AUC on the device for use inside a training loop.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["evaluate_ctr", "auc_score", "log_loss", "grouped_auc",
           "auc_torch"]


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


def _group_segments(group_id: np.ndarray):
    """Sort by group; return (order, segment start offsets, lengths)."""
    order = np.argsort(group_id, kind="mergesort")
    g = group_id[order]
    boundary = np.ones(len(g), dtype=bool)
    boundary[1:] = g[1:] != g[:-1]
    starts = np.flatnonzero(boundary)
    lengths = np.diff(np.append(starts, len(g)))
    return order, starts, lengths


def grouped_auc(y_true, y_pred, group_id, weighted: bool = True) -> float:
    """gAUC (weighted=True, by group size) or avgAUC (weighted=False);
    single-class groups are skipped."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    group_id = np.asarray(group_id).reshape(-1)
    order, starts, lengths = _group_segments(group_id)
    yt, yp = y_true[order], y_pred[order]
    num, den = 0.0, 0.0
    for s, n in zip(starts, lengths):
        t = yt[s:s + n]
        pos = float(np.sum(t > 0))
        if pos == 0 or pos == n:
            continue
        w = float(n) if weighted else 1.0
        num += auc_score(t, yp[s:s + n]) * w
        den += w
    return num / den if den > 0 else 0.0


def _grouped_rank_metric(y_true, y_pred, group_id, fn) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    group_id = np.asarray(group_id).reshape(-1)
    order, starts, lengths = _group_segments(group_id)
    yt, yp = y_true[order], y_pred[order]
    total, count = 0.0, 0
    for s, n in zip(starts, lengths):
        total += fn(yt[s:s + n], yp[s:s + n])
        count += 1
    return total / max(count, 1)


def _mrr(y_true, y_pred) -> float:
    order = np.argsort(-y_pred, kind="mergesort")
    t = y_true[order]
    rr = t / (np.arange(len(t)) + 1.0)
    return float(np.sum(rr) / (np.sum(t) + 1e-12))


def _ndcg(y_true, y_pred, k: int) -> float:
    def dcg(t, p):
        order = np.argsort(-p, kind="mergesort")[:k]
        gains = 2.0 ** t[order] - 1.0
        discounts = np.log2(np.arange(len(order)) + 2.0)
        return float(np.sum(gains / discounts))
    idcg = dcg(y_true, y_true)
    return dcg(y_true, y_pred) / (idcg + 1e-12)


_NDCG_K = re.compile(r"(?:k\s*=\s*|@)(\d+)")


def evaluate_ctr(y_true: np.ndarray, y_pred: np.ndarray,
                 metrics: Sequence[str],
                 group_id: Optional[np.ndarray] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Dict[str, float]:
    """{metric: value} over host arrays. The grouped metrics (gAUC, avgAUC,
    MRR, NDCG@k / NDCG(k=..)) need ``group_id`` and run on ``device`` (the
    CUDA device unless named), all in one pass."""
    out: "OrderedDict[str, float]" = OrderedDict()
    grouped_names, ndcg_ks = [], []
    for metric in metrics:
        if metric in ("gAUC", "avgAUC", "MRR"):
            grouped_names.append(metric)
        elif metric.startswith("NDCG"):
            m = _NDCG_K.search(metric)
            if metric != "NDCG" and m is None:
                raise ValueError(
                    f"cannot parse k from metric {metric!r}; use "
                    "'NDCG(k=10)' or 'NDCG@10'")
            ndcg_ks.append(int(m.group(1)) if m else 10)
    grouped_vals = None
    if grouped_names or ndcg_ks:
        if group_id is None:
            raise ValueError("group_index is required.")
        from recbox_tpu_torch.evaluation.grouped import (
            grouped_metrics_device,
        )
        grouped_vals = grouped_metrics_device(
            y_true, y_pred, group_id, grouped_names,
            ndcg_ks=tuple(dict.fromkeys(ndcg_ks)), device=device)
    yt = np.asarray(y_true, np.float64).reshape(-1)
    yp = np.asarray(y_pred, np.float64).reshape(-1)
    for metric in metrics:
        if metric in ("logloss", "binary_crossentropy"):
            out[metric] = log_loss(y_true, y_pred)
        elif metric == "AUC":
            out[metric] = auc_score(y_true, y_pred)
        elif metric in ("ACC", "accuracy"):
            out[metric] = float(np.mean(
                (np.asarray(y_pred).reshape(-1) > 0.5)
                == (np.asarray(y_true).reshape(-1) > 0.5)))
        elif metric == "MAE":
            out[metric] = float(np.mean(np.abs(yt - yp)))
        elif metric == "RMSE":
            out[metric] = float(np.sqrt(np.mean(np.square(yt - yp))))
        elif metric in ("gAUC", "avgAUC", "MRR"):
            out[metric] = grouped_vals[metric]
        elif metric.startswith("NDCG"):
            m = _NDCG_K.search(metric)
            out[metric] = grouped_vals[f"NDCG@{int(m.group(1)) if m else 10}"]
        else:
            raise ValueError(f"metric={metric} not supported.")
    return dict(out)


def auc_torch(probs: torch.Tensor, labels: torch.Tensor,
              num_buckets: int = 8192) -> torch.Tensor:
    """Histogram AUC on the tensors' device, no host sync (error <= ~1 /
    num_buckets): probabilities in [0, 1] fall into buckets, and AUC =
    sum_b pos(b) · (neg below b + neg(b) / 2) / (pos · neg). The exact
    `auc_score` stays the final evaluation's."""
    probs = probs.reshape(-1)
    labels = labels.reshape(-1).to(torch.float32)
    b = torch.clamp((probs * num_buckets).to(torch.int32), 0,
                    num_buckets - 1).to(torch.int64)
    zeros = torch.zeros(num_buckets, dtype=torch.float32,
                        device=probs.device)
    pos_hist = zeros.index_add(0, b, labels)
    neg_hist = zeros.index_add(0, b, 1.0 - labels)
    neg_below = torch.cumsum(neg_hist, 0) - neg_hist
    num = torch.sum(pos_hist * (neg_below + 0.5 * neg_hist))
    den = torch.sum(pos_hist) * torch.sum(neg_hist)
    return num / torch.clamp(den, min=1e-12)
