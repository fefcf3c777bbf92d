"""Grouped CTR metrics on the device: gAUC / avgAUC / MRR / NDCG@k.

Counterpart of `recbox_tpu/evaluation/grouped.py`: every group's metric from
three stable lexsorts and flat segment reductions, with no per-group
control flow, in float32 as in the JAX package:

  sort 1, keys (group, pred asc): tie-averaged within-group ranks for the
      Mann-Whitney AUC;
  sort 2, keys (group, pred desc): descending ranks for MRR and the DCG
      numerator (ties in row order, as the host engine's mergesort);
  sort 3, keys (group, label desc): ideal ranks for the IDCG denominator.

A lexsort is two stable sorts, the secondary key first. gAUC weights groups
by row count and avgAUC equally, both skipping single-class groups; MRR and
NDCG average over every group. The host loop (`evaluation/ctr.py`
`grouped_auc`, `_mrr`, `_ndcg`) is the reference. Segment sums use
`index_add_`, whose order on the card varies from run to run.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device

__all__ = ["grouped_metrics_device"]


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(secondary, stable=True)
    return order[torch.argsort(primary[order], stable=True)]


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _seg_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(
        0, seg, vals)


def _group_layout(group_sorted: torch.Tensor):
    """(boundary, segment id, group start, 1-based rank in the group) of
    rows sorted by group."""
    n = group_sorted.shape[0]
    idx = torch.arange(n, device=group_sorted.device)
    boundary = torch.ones(n, dtype=torch.bool, device=group_sorted.device)
    boundary[1:] = group_sorted[1:] != group_sorted[:-1]
    seg = torch.cumsum(boundary, 0) - 1
    gstart = _cummax(torch.where(boundary, idx, -1))
    return boundary, seg, gstart, idx - gstart + 1


def _grouped(y: torch.Tensor, p: torch.Tensor, g: torch.Tensor,
             ks: Tuple[int, ...]):
    """(gAUC, avgAUC, MRR, {k: NDCG@k}) as device scalars."""
    n = y.shape[0]
    y = y.to(torch.float32)
    p = p.to(torch.float32)
    idx = torch.arange(n, device=y.device)
    ones = torch.ones(n, dtype=torch.float32, device=y.device)

    # sort 1: (group, pred asc) -> tie-averaged AUC ranks
    o1 = _lexsort(g, p)
    g1, y1, p1 = g[o1], y[o1], p[o1]
    b1, seg1, gstart1, _ = _group_layout(g1)
    tie_b = b1.clone()
    tie_b[1:] |= p1[1:] != p1[:-1]
    tie_id = torch.cumsum(tie_b, 0) - 1
    tie_start = _cummax(torch.where(tie_b, idx, -1))
    tie_len = _seg_sum(ones, tie_id, n)[tie_id]
    # first rank of the tie run + (len - 1) / 2 = the shared average rank
    avg_rank = (tie_start - gstart1 + 1).to(torch.float32) \
        + (tie_len - 1.0) / 2.0
    pos1 = (y1 > 0).to(torch.float32)
    cnt = _seg_sum(ones, seg1, n)
    npos = _seg_sum(pos1, seg1, n)
    nneg = cnt - npos
    pos_rank_sum = _seg_sum(avg_rank * pos1, seg1, n)
    denom = torch.clamp(npos * nneg, min=1.0)
    auc_g = (pos_rank_sum - npos * (npos + 1.0) / 2.0) / denom
    two_class = (npos > 0) & (nneg > 0)
    w_cnt = torch.where(two_class, cnt, 0.0)
    gauc = torch.sum(auc_g * w_cnt) / torch.clamp(torch.sum(w_cnt),
                                                  min=1e-12)
    n_valid = torch.sum(two_class).to(torch.float32)
    avgauc = torch.sum(torch.where(two_class, auc_g, 0.0)) \
        / torch.clamp(n_valid, min=1e-12)
    gauc = torch.where(torch.sum(w_cnt) > 0, gauc, 0.0)
    avgauc = torch.where(n_valid > 0, avgauc, 0.0)

    # sort 2: (group, pred desc) -> MRR and DCG
    o2 = _lexsort(g, -p)
    g2, y2 = g[o2], y[o2]
    b2, seg2, _, rank2 = _group_layout(g2)
    n_groups = torch.sum(b2).to(torch.float32)
    occupied = _seg_sum(ones, seg2, n) > 0
    rr = y2 / rank2.to(torch.float32)
    mrr_g = _seg_sum(rr, seg2, n) / (_seg_sum(y2, seg2, n) + 1e-12)
    mrr = torch.sum(torch.where(occupied, mrr_g, 0.0)) \
        / torch.clamp(n_groups, min=1.0)

    # sort 3: (group, label desc) -> IDCG
    o3 = _lexsort(g, -y)
    g3, y3 = g[o3], y[o3]
    _, seg3, _, rank3 = _group_layout(g3)

    ndcgs = {}
    for k in ks:
        disc2 = torch.where(
            rank2 <= k, 1.0 / torch.log2(rank2.to(torch.float32) + 1.0), 0.0)
        dcg_g = _seg_sum((torch.exp2(y2) - 1.0) * disc2, seg2, n)
        disc3 = torch.where(
            rank3 <= k, 1.0 / torch.log2(rank3.to(torch.float32) + 1.0), 0.0)
        idcg_g = _seg_sum((torch.exp2(y3) - 1.0) * disc3, seg3, n)
        ndcg_g = dcg_g / (idcg_g + 1e-12)
        ndcgs[k] = torch.sum(torch.where(occupied, ndcg_g, 0.0)) \
            / torch.clamp(n_groups, min=1.0)
    return gauc, avgauc, mrr, ndcgs


def grouped_metrics_device(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    group_id: np.ndarray,
    metrics: Sequence[str],
    ndcg_ks: Sequence[int] = (),
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """The grouped metrics on ``device`` (the CUDA device unless named).

    ``metrics`` takes 'gAUC' / 'avgAUC' / 'MRR' exactly (anything else
    raises: a typo must not drop a metric); NDCG cutoffs go in ``ndcg_ks``
    and come back under the keys ``'NDCG@{k}'``."""
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a).reshape(-1)).to(dev)

    gauc, avgauc, mrr, ndcgs = _grouped(put(y_true), put(y_pred),
                                        put(group_id), tuple(ndcg_ks))
    out = {}
    for m in metrics:
        if m == "gAUC":
            out[m] = float(gauc)
        elif m == "avgAUC":
            out[m] = float(avgauc)
        elif m == "MRR":
            out[m] = float(mrr)
        else:
            raise ValueError(
                f"unknown grouped metric {m!r}; expected gAUC/avgAUC/MRR "
                "(NDCG cutoffs go in ndcg_ks)")
    for k in ndcg_ks:
        out[f"NDCG@{k}"] = float(ndcgs[k])
    return out
