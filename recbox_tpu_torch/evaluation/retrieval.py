"""Full-corpus retrieval evaluation: exact top-k over the catalog, then the
ranking metrics, on the device.

Counterpart of `recbox_tpu/evaluation/retrieval.py`: a chunk of users is
scored against every item with one (chunk × V) product (a `torch.matmul`,
as JAX leaves it to XLA), the users' train items (and ``exclude_items``)
get -1e9 added before the selection, so the mask is exact, and
`torch.topk` takes the top k (the JAX evaluator uses `lax.top_k`, not the
B5 kernel; so does this one, so that its cost stays plain). Items of equal
score may come out in another order than `lax.top_k`'s (index ascending).

Metric strings use the reference spelling, "Recall(k=20)", "NDCG(k=10)",
...: Recall, nRecall, Precision, F1, DCG, NDCG, MRR (the sum of reciprocal
ranks of every hit), StdMRR (the first hit's), HitRate, MAP (normalised by
the hits retrieved) and StdMAP (by min(|relevant|, k)). DCG uses the
natural log, as the reference does; NDCG does not depend on the base.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device

__all__ = ["evaluate_retrieval", "retrieval_metrics_from_topk",
           "parse_metric", "std_gauc", "full_sort_topk"]

NEG_INF = -1e9
_METRIC_RE = re.compile(r"^(\w+)\(k=(\d+)\)$")


def parse_metric(metric: str) -> Tuple[str, int]:
    m = _METRIC_RE.match(metric.replace(" ", ""))
    if not m:
        raise NotImplementedError(f"metrics={metric} not implemented.")
    return m.group(1), int(m.group(2))


def _pad_lists(list_of_lists: Sequence[Sequence[int]], pad: int
               ) -> np.ndarray:
    max_len = max(max((len(l) for l in list_of_lists), default=1), 1)
    out = np.full((len(list_of_lists), max_len), pad, dtype=np.int64)
    for i, l in enumerate(list_of_lists):
        if len(l):
            out[i, :len(l)] = np.asarray(list(l), dtype=np.int64)
    return out


def _as_device(x, dev: torch.device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x))).to(dev)


def _scores(user_embs: torch.Tensor, item_embs: torch.Tensor
            ) -> torch.Tensor:
    """(U, V) f32 scores; a (U, K, D) multi-interest user scores each item
    by its best interest."""
    u, t = user_embs.float(), item_embs.float()
    if u.ndim == 3:
        return torch.einsum("ukd,id->uki", u, t).amax(dim=1)
    return u @ t.T


def _topk_chunk(user_embs: torch.Tensor, item_embs: torch.Tensor,
                train_items: torch.Tensor, max_topk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k item ids after adding -1e9 at each train item (repeats add
    again; ids outside [0, V), the pads, are dropped) and those items'
    unmasked scores."""
    scores = _scores(user_embs, item_embs)
    n_items = scores.shape[1]
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None] \
        .expand_as(train_items)
    keep = (train_items >= 0) & (train_items < n_items)
    masked = scores.index_put((rows[keep], train_items[keep]),
                              torch.tensor(NEG_INF, device=scores.device),
                              accumulate=True)
    top_items = topk_lowest_index(masked, max_topk)
    return top_items, torch.gather(scores, 1, top_items)


def topk_lowest_index(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise top-k ids in `jax.lax.top_k`'s order: by score, equal
    scores by ascending id (`torch.topk` sets no order among ties, which
    moves an NDCG where a row's scores tie, as an empty history's all-zero
    interests do). A row whose k-th score ties one left out is ranked by a
    stable sort of the whole row."""
    vals, idx = torch.topk(scores, k, dim=1)
    over = torch.sum(scores >= vals[:, -1:], dim=1) > k
    if bool(over.any()):
        rows = torch.nonzero(over).squeeze(1)
        idx[rows] = torch.sort(scores[rows], dim=1, descending=True,
                               stable=True).indices[:, :k]
    idx = torch.sort(idx, dim=1).values
    order = torch.sort(torch.gather(scores, 1, idx), dim=1, descending=True,
                       stable=True).indices
    return torch.gather(idx, 1, order)


def _metrics_chunk(topk_items: torch.Tensor, true_items: torch.Tensor,
                   ks: Tuple[Tuple[str, int], ...]) -> Dict[str, torch.Tensor]:
    """Per-user metric values for every (name, k) from top-k ids and the
    true ids (padded with -1)."""
    valid = true_items >= 0                                       # (C, T)
    num_true = torch.sum(valid, dim=1).to(torch.float32)          # (C,)
    eq = (topk_items[:, :, None] == true_items[:, None, :]) & valid[:, None]
    hits = torch.any(eq, dim=-1).to(torch.float32)                # (C, K)
    pos = torch.arange(topk_items.shape[1], dtype=torch.float32,
                       device=topk_items.device)
    disc = 1.0 / torch.log(2.0 + pos)
    out = {}
    for name, k in ks:
        h = hits[:, :k]
        nh = torch.sum(h, dim=1)
        if name == "Recall":
            val = nh / (num_true + 1e-12)
        elif name == "nRecall":
            val = nh / torch.clamp(num_true + 1e-12, max=float(k))
        elif name == "Precision":
            val = nh / (k + 1e-12)
        elif name == "F1":
            p = nh / (k + 1e-12)
            r = nh / (num_true + 1e-12)
            val = 2 * p * r / (p + r + 1e-12)
        elif name == "DCG":
            val = torch.sum(h * disc[:k], dim=1)
        elif name == "NDCG":
            dcg = torch.sum(h * disc[:k], dim=1)
            ideal_n = torch.clamp(num_true, max=float(k))
            icum = torch.cat([torch.zeros(1, device=disc.device),
                              torch.cumsum(disc[:k], 0)])
            idcg = icum[torch.clamp(ideal_n, 0, k).to(torch.int64)]
            val = dcg / (idcg + 1e-12)
        elif name == "MRR":
            val = torch.sum(h / (pos[:k] + 1.0), dim=1)
        elif name == "StdMRR":
            first = torch.argmax(h, dim=1)
            val = torch.where(nh > 0, 1.0 / (first + 1.0), 0.0)
        elif name == "HitRate":
            val = (nh > 0).to(torch.float32)
        elif name == "MAP":
            prec_at_i = torch.cumsum(h, dim=1) / (pos[:k] + 1.0)
            val = torch.sum(prec_at_i * h, dim=1) / (nh + 1e-12)
        elif name == "StdMAP":
            prec_at_i = torch.cumsum(h, dim=1) / (pos[:k] + 1.0)
            val = torch.sum(prec_at_i * h, dim=1) \
                / (torch.clamp(num_true, max=float(k)) + 1e-12)
        else:
            raise NotImplementedError(f"metric {name}")
        out[f"{name}(k={k})"] = val
    return out


def evaluate_retrieval(
    user_embs, item_embs,
    train_user2items: Mapping[int, Sequence[int]],
    valid_user2items: Mapping[int, Sequence[int]],
    query_indices: Sequence[int],
    metrics: Sequence[str] = ("Recall(k=20)", "NDCG(k=10)"),
    chunk_size: int = 1024,
    exclude_items: Sequence[int] = (),
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """{metric: mean over the users} of a full-sort evaluation.

    ``user_embs`` (U, D) or (U, K, D) and ``item_embs`` (V, D), numpy or
    tensors, one user row per entry of ``query_indices``; per-user train
    and valid item lists. ``exclude_items`` are masked for every user (e.g.
    a PAD row 0). A user's duplicate valid ids count once. Runs on
    ``device`` (the CUDA device unless named); the (chunk, V) f32 score
    buffer is held to 2^28 floats (1 GB), so at V = 1M a chunk is 256
    users whatever ``chunk_size`` asks."""
    dev = resolve_device(device)
    parsed = tuple(parse_metric(m) for m in metrics)
    max_topk = max(k for _, k in parsed)
    num_users = len(user_embs)
    num_items = item_embs.shape[0]
    chunk_size = max(1, min(chunk_size, (1 << 28) // max(num_items, 1)))
    excl = list(exclude_items)
    train_padded = _pad_lists(
        [list(train_user2items.get(q, ())) + excl for q in query_indices],
        pad=num_items)
    true_padded = _pad_lists(
        [list(dict.fromkeys(valid_user2items.get(q, ())))
         for q in query_indices], pad=-1)
    item_embs = _as_device(item_embs, dev)
    sums = {f"{n}(k={k})": 0.0 for n, k in parsed}
    for start in range(0, num_users, chunk_size):
        end = min(start + chunk_size, num_users)
        topk, _ = _topk_chunk(
            _as_device(user_embs[start:end], dev), item_embs,
            _as_device(train_padded[start:end], dev), max_topk)
        vals = _metrics_chunk(topk, _as_device(true_padded[start:end], dev),
                              parsed)
        for key, v in vals.items():
            sums[key] += float(torch.sum(v))
    return {m: sums[f"{n}(k={k})"] / num_users
            for m, (n, k) in zip(metrics, parsed)}


def std_gauc(scores: np.ndarray, pos_matrix: np.ndarray) -> float:
    """Full-sort GAUC with recbole's semantics: per user, the AUC over the
    rankable items (entries scored -inf are masked history / PAD), ties at
    their average rank, users without a positive or without a negative left
    out, the AUCs weighted by each user's positive count."""
    from recbox_tpu_torch.evaluation.ctr import auc_score

    scores = np.asarray(scores, dtype=np.float64)
    pos_matrix = np.asarray(pos_matrix)
    num, den = 0.0, 0.0
    for u in range(scores.shape[0]):
        rankable = np.isfinite(scores[u])
        t = pos_matrix[u][rankable]
        n_pos = float(t.sum())
        if n_pos == 0 or n_pos == len(t):
            continue
        num += auc_score(t, scores[u][rankable]) * n_pos
        den += n_pos
    return num / den if den > 0 else 0.0


def retrieval_metrics_from_topk(topk_items, true_items, metrics,
                                device: Optional[Union[str, torch.device]]
                                = None) -> Dict[str, float]:
    """Metrics from precomputed top-k ids and true ids padded with -1."""
    dev = resolve_device(device)
    parsed = tuple(parse_metric(m) for m in metrics)
    vals = _metrics_chunk(_as_device(topk_items, dev),
                          _as_device(true_items, dev), parsed)
    return {m: float(torch.mean(vals[f"{n}(k={k})"]))
            for m, (n, k) in zip(metrics, parsed)}


def full_sort_topk(user_embs, item_embs, k: int, train_items=None,
                   device: Optional[Union[str, torch.device]] = None):
    """(scores, item ids) of each user's top k over the whole corpus as
    numpy arrays, train items (padded with V) masked first."""
    dev = resolve_device(device)
    user_embs = _as_device(user_embs, dev)
    item_embs = _as_device(item_embs, dev)
    if train_items is None:
        train_items = torch.full((user_embs.shape[0], 1), item_embs.shape[0],
                                 dtype=torch.int64, device=dev)
    ids, top_scores = _topk_chunk(user_embs, item_embs,
                                  _as_device(train_items, dev).long(), k)
    return top_scores.cpu().numpy(), ids.cpu().numpy()
