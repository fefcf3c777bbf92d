"""Candidate-set (sampled-negative) retrieval evaluation: 'uniN' / 'popN'.

Counterpart of `recbox_tpu/evaluation/candidate.py`, recbole's
NegSampleEvalDataLoader protocol: each evaluated user's positives are
ranked against ``num_negs`` negatives a positive, drawn uniformly ('uni')
or by popularity ('pop'), the user's train and evaluation positives
excluded by bounded re-draws.

`parse_protocol` and `sample_eval_candidates` are numpy copies (the same
generator calls in the same order, so the candidate matrix equals JAX's
bit for bit). `candidate_topk` scores a chunk of users against its
(U, C, D) gathered candidates with one ``einsum`` and ranks them with a
stable descending sort (JAX leaves both to XLA, outside any Pallas
kernel), so equal scores come out position ascending, as `lax.top_k`
gives them: a user without positives has only masked slots, and its list
is then their first k, as in JAX. The metrics are the full-sort engine's
(`evaluation/retrieval.py` `_metrics_chunk`).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.data.sampling import AliasTable
from recbox_tpu_torch.evaluation.retrieval import (
    NEG_INF, _as_device, _metrics_chunk, _pad_lists, parse_metric,
)

__all__ = ["parse_protocol", "sample_eval_candidates", "candidate_topk",
           "evaluate_candidate_retrieval"]

_PROTO_RE = re.compile(r"^(uni|pop)(\d+)$")


def parse_protocol(protocol: str) -> Tuple[str, int]:
    """'uni100' -> ('uniform', 100); 'pop50' -> ('popularity', 50); any
    other spelling raises NotImplementedError."""
    m = _PROTO_RE.match(protocol)
    if not m:
        raise NotImplementedError(
            f"eval protocol {protocol!r}; expected 'full', 'uniN' or 'popN'")
    return ("uniform" if m.group(1) == "uni" else "popularity",
            int(m.group(2)))


def sample_eval_candidates(
    query_indices: Sequence[int],
    train_user2items: Mapping[int, Sequence[int]],
    valid_user2items: Mapping[int, Sequence[int]],
    num_items: int,
    num_negs: int,
    distribution: str = "uniform",
    item_counts: Optional[np.ndarray] = None,
    seed: int = 2024,
    max_attempts: int = 50,
    exclude_items: Sequence[int] = (),
    user_chunk: Optional[int] = None,
):
    """The candidate matrix of every evaluated user.

    Returns (cand_ids (U, C) int32, cand_valid (U, C) bool, true_padded
    (U, P) int32 padded with -1), C = P·(1 + num_negs), P the most
    positives of a user (duplicates collapsed). A row is [P positive slots
    | P·num_negs negative slots]; a user with n positives has n·num_negs
    valid negatives, and padded positive slots hold id ``num_items``.
    Negatives avoid the user's train and evaluation positives and
    ``exclude_items`` by re-draws; after ``max_attempts`` rounds a draw
    that still collides is kept (the reference gives up on ultra-dense
    users the same way). Users are processed ``user_chunk`` at a time
    (default: a bitmap of at most 2^28 entries)."""
    rng = np.random.default_rng(seed)
    query_indices = np.asarray(query_indices)
    U = len(query_indices)
    true_lists = [list(dict.fromkeys(valid_user2items.get(int(q), ())))
                  for q in query_indices]
    P = max((len(l) for l in true_lists), default=1) or 1
    true_padded = _pad_lists(true_lists, pad=-1).astype(np.int32)
    n_neg = P * num_negs

    if distribution == "popularity":
        if item_counts is None:
            raise ValueError("popularity protocol needs item_counts")
        probs = np.asarray(item_counts, dtype=np.float64)
        probs = np.where(probs > 0, probs, 0.0)
        if probs.sum() == 0:
            probs = np.ones(num_items)
        alias = AliasTable(probs)
        draw = lambda size: alias.sample(size, rng).astype(np.int64)
    elif distribution == "uniform":
        draw = lambda size: rng.integers(0, num_items, size=size)
    else:
        raise NotImplementedError(f"distribution={distribution}")

    excl = np.array([it for it in exclude_items if 0 <= it < num_items],
                    dtype=np.int64)
    chunk = user_chunk or max(1, min(U, (1 << 28) // (num_items + 1)))
    negs = np.empty((U, n_neg), dtype=np.int64)
    for c0 in range(0, U, chunk):
        c1 = min(c0 + chunk, U)
        uc = c1 - c0
        used = np.zeros((uc, num_items + 1), dtype=bool)
        if excl.size:
            used[:, excl] = True
        for i in range(c0, c1):
            q = int(query_indices[i])
            for it in train_user2items.get(q, ()):
                if 0 <= it < num_items:
                    used[i - c0, it] = True
            for it in true_lists[i]:
                used[i - c0, it] = True
        neg_c = draw((uc, n_neg))
        rows = np.arange(uc)[:, None]
        for _ in range(max_attempts):
            bad = used[rows, neg_c]
            n_bad = int(bad.sum())
            if n_bad == 0:
                break
            neg_c[bad] = draw(n_bad)
        negs[c0:c1] = neg_c

    pos_part = np.where(true_padded >= 0, true_padded, num_items)
    cand_ids = np.concatenate([pos_part, negs], axis=1).astype(np.int32)
    n_pos = (true_padded >= 0).sum(axis=1, keepdims=True)
    neg_valid = np.arange(n_neg)[None, :] < n_pos * num_negs
    cand_valid = np.concatenate([true_padded >= 0, neg_valid], axis=1)
    return cand_ids, cand_valid, true_padded


def candidate_topk(user_embs: torch.Tensor, item_embs: torch.Tensor,
                   cand_ids: torch.Tensor, cand_valid: torch.Tensor,
                   max_topk: int) -> torch.Tensor:
    """The top-k item ids among each user's candidates (invalid slots
    score NEG_INF; ties position ascending); a (U, K, D) multi-interest
    user scores a candidate by its best interest."""
    cand_embs = item_embs[torch.clamp(cand_ids.long(),
                                      max=item_embs.shape[0] - 1)]
    u = user_embs.to(cand_embs.dtype)
    if u.ndim == 3:
        scores = torch.einsum("ukd,ucd->ukc", u, cand_embs).amax(dim=1)
    else:
        scores = torch.einsum("ud,ucd->uc", u, cand_embs)
    scores = torch.where(cand_valid, scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    k = min(max_topk, cand_ids.shape[1])
    pos = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return torch.gather(cand_ids, 1, pos[:, :k])


def evaluate_candidate_retrieval(
    user_embs, item_embs,
    cand_ids: np.ndarray, cand_valid: np.ndarray, true_padded: np.ndarray,
    metrics: Sequence[str], chunk_size: int = 1024,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """{metric: mean over the users} over the sampled candidate lists, on
    ``device`` (the CUDA device unless named)."""
    dev = resolve_device(device)
    parsed = tuple(parse_metric(m) for m in metrics)
    max_topk = max(k for _, k in parsed)
    num_users = len(user_embs)
    item_embs = _as_device(item_embs, dev)
    sums = {f"{n}(k={k})": 0.0 for n, k in parsed}
    for start in range(0, num_users, chunk_size):
        end = min(start + chunk_size, num_users)
        topk = candidate_topk(
            _as_device(user_embs[start:end], dev), item_embs,
            _as_device(cand_ids[start:end], dev),
            _as_device(cand_valid[start:end], dev), max_topk)
        vals = _metrics_chunk(topk, _as_device(true_padded[start:end],
                                               dev).long(), parsed)
        for key, v in vals.items():
            sums[key] += float(torch.sum(v))
    return {m: sums[f"{n}(k={k})"] / num_users
            for m, (n, k) in zip(metrics, parsed)}
