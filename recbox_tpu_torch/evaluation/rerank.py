"""Listwise reranking metrics: MAP@k / NDCG@k / clicks@k over scored lists.

The port's own copy of `recbox_tpu/evaluation/rerank.py` (numpy only; the
port imports nothing of the JAX package), unchanged in function.

Vectorized equivalent of librerank's `evaluate_multi`
(`third_party/librerank/utils.py:318-385`): lists are reordered by predicted
score, metrics computed against the click labels, averaged over lists.
Optional position-bias de-biasing divides clicks by propensities before
scoring (the reference's `props` path).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["evaluate_rerank", "build_rerank_lists"]


def evaluate_rerank(
    scores: np.ndarray,          # (B, N) predicted scores
    labels: np.ndarray,          # (B, N) clicks/relevance
    mask: Optional[np.ndarray] = None,   # (B, N) valid positions
    ks: Sequence[int] = (5, 10),
    props: Optional[np.ndarray] = None,  # (B, N) position propensities
) -> Dict[str, float]:
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    B, N = scores.shape
    if mask is None:
        mask = np.ones_like(scores, dtype=bool)
    else:
        mask = np.asarray(mask, dtype=bool)
    if props is not None:
        labels = labels / np.clip(np.asarray(props, dtype=np.float64), 1e-6, None)
    scores = np.where(mask, scores, -np.inf)
    order = np.argsort(-scores, axis=1, kind="stable")
    sorted_labels = np.take_along_axis(labels * mask, order, axis=1)
    out: Dict[str, float] = {}
    for k in ks:
        kk = min(k, N)   # lists shorter than k: score what exists
        top = sorted_labels[:, :kk]
        # clicks captured in top-k
        out[f"clicks@{k}"] = float(np.mean(np.sum(top, axis=1)))
        # MAP@k over binarized labels
        binary = (top > 0).astype(np.float64)
        cum = np.cumsum(binary, axis=1)
        prec = cum / (np.arange(kk) + 1.0)
        hits = np.sum(binary, axis=1)
        ap = np.sum(prec * binary, axis=1) / np.maximum(hits, 1.0)
        out[f"MAP@{k}"] = float(np.mean(np.where(hits > 0, ap, 0.0)))
        # NDCG@k with EXPONENTIAL gain 2^label − 1 (librerank
        # evaluate_multi; linear gain coincides only for binary labels —
        # de-biased fractional labels and graded clicks need the reference
        # gain for comparable numbers)
        disc = 1.0 / np.log2(np.arange(kk) + 2.0)
        # cap the exponent: de-biased labels (label/propensity) can reach
        # the thousands for tail propensities, and 2^1024 overflows f64 to
        # inf, making dcg/idcg = inf/inf = NaN and poisoning the mean. At
        # 2^500 the largest gain already dominates every other term, so
        # the capped ratio is unchanged for any realistic list
        _EXP_CAP = 500.0
        dcg = np.sum((np.exp2(np.minimum(top, _EXP_CAP)) - 1.0) * disc,
                     axis=1)
        ideal = np.take_along_axis(
            labels * mask, np.argsort(-(labels * mask), axis=1, kind="stable"),
            axis=1)[:, :kk]
        idcg = np.sum((np.exp2(np.minimum(ideal, _EXP_CAP)) - 1.0) * disc,
                      axis=1)
        out[f"NDCG@{k}"] = float(np.mean(np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)))
    return out


def build_rerank_lists(query_ids: np.ndarray, item_feats: np.ndarray,
                       labels: np.ndarray, list_size: int,
                       scores: Optional[np.ndarray] = None
                       ) -> Dict[str, np.ndarray]:
    """Group per-(query, candidate) rows into fixed-size rerank lists —
    librerank's `construct_list` (`librerank/utils.py:153`) analog.

    Rows are grouped by query id; within a query, candidates are ordered by
    `scores` descending (the upstream ranker's order) or input order, then
    truncated/zero-padded to `list_size`. Returns {item_feats (Q, N, D),
    labels (Q, N), mask (Q, N), query_ids (Q,)}.
    """
    query_ids = np.asarray(query_ids)
    order = np.argsort(query_ids, kind="stable")
    qs = query_ids[order]
    boundary = np.ones(len(qs), bool)
    boundary[1:] = qs[1:] != qs[:-1]
    starts = np.flatnonzero(boundary)
    Q = len(starts)
    D = item_feats.shape[-1]
    out_f = np.zeros((Q, list_size, D), np.float32)
    out_l = np.zeros((Q, list_size), np.float32)
    out_m = np.zeros((Q, list_size), bool)
    out_q = np.zeros((Q,), query_ids.dtype)
    ends = np.append(starts[1:], len(qs))
    for k, (s, e) in enumerate(zip(starts, ends)):
        rows = order[s:e]
        if scores is not None:
            rows = rows[np.argsort(-np.asarray(scores)[rows], kind="stable")]
        rows = rows[:list_size]
        n = len(rows)
        out_f[k, :n] = item_feats[rows]
        out_l[k, :n] = labels[rows]
        out_m[k, :n] = True
        out_q[k] = qs[s]
    return {"item_feats": out_f, "labels": out_l, "mask": out_m,
            "query_ids": out_q}
