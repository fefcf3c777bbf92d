"""Sequential dataset construction: sliding windows + leave-one-out splits.

The port's own copy (numpy only) of `recbox_tpu/data/sequential.py`:
`group_user_sequences` (per-user chronological item lists),
`build_sliding_windows` (every prefix of a user's list becomes one
(history, next item) sample, the history truncated to the most recent
``max_len`` items, recbole's sequential augmentation) and
`leave_one_out_split` (last interaction = test, second-to-last = valid,
the rest = train).

Outputs static-shape arrays: item_seq (N, max_len) left-padded with 0 (item
ids must therefore be >= 1; 0 is PAD), seq_len (N,), target item id (N,).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["build_sliding_windows", "leave_one_out_split", "group_user_sequences"]


def group_user_sequences(
    user_ids: np.ndarray,
    item_ids: np.ndarray,
    timestamps: Optional[np.ndarray] = None,
) -> Dict[int, np.ndarray]:
    """Group interactions into per-user chronological item lists."""
    user_ids = np.asarray(user_ids)
    item_ids = np.asarray(item_ids)
    if timestamps is not None:
        order = np.lexsort((np.asarray(timestamps), user_ids))
    else:
        order = np.argsort(user_ids, kind="stable")  # keep log order in-user
    u, it = user_ids[order], item_ids[order]
    boundary = np.ones(len(u), dtype=bool)
    boundary[1:] = u[1:] != u[:-1]
    starts = np.flatnonzero(boundary)
    out = {}
    for i, s in enumerate(starts):
        e = starts[i + 1] if i + 1 < len(starts) else len(u)
        out[int(u[s])] = it[s:e]
    return out


def build_sliding_windows(
    user_seqs: Dict[int, np.ndarray],
    max_len: int = 50,
    min_hist: int = 1,
) -> Dict[str, np.ndarray]:
    """Every prefix →(history, next-item) sample; history left-padded with 0.

    Matches recbole's augmentation: for a user sequence [i1..in], emit
    samples ([i1..ik] → i_{k+1}) for k ≥ min_hist, history truncated to the
    most recent ``max_len`` items.
    """
    users, seqs, lens, targets = [], [], [], []
    for uid, items in user_seqs.items():
        n = len(items)
        for k in range(min_hist, n):
            hist = items[max(0, k - max_len):k]
            row = np.zeros(max_len, dtype=np.int32)
            row[max_len - len(hist):] = hist
            users.append(uid)
            seqs.append(row)
            lens.append(len(hist))
            targets.append(items[k])
    return {
        "user_id": np.asarray(users, dtype=np.int32),
        "item_seq": np.stack(seqs) if seqs else np.zeros((0, max_len), np.int32),
        "seq_len": np.asarray(lens, dtype=np.int32),
        "item_id": np.asarray(targets, dtype=np.int32),
    }


def leave_one_out_split(
    user_seqs: Dict[int, np.ndarray],
    max_len: int = 50,
    min_hist: int = 1,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """LS split: train on all-but-2 prefixes; valid/test = the last two targets.

    Returns (train, valid, test) array dicts in the sliding-window layout.
    Users with < min_hist+2 interactions contribute no valid/test rows.
    """
    train_seqs: Dict[int, np.ndarray] = {}
    v_users, v_seqs, v_lens, v_targets = [], [], [], []
    t_users, t_seqs, t_lens, t_targets = [], [], [], []

    def pad(hist):
        hist = hist[-max_len:]
        row = np.zeros(max_len, dtype=np.int32)
        row[max_len - len(hist):] = hist
        return row, len(hist)

    for uid, items in user_seqs.items():
        if len(items) < min_hist + 2:
            train_seqs[uid] = items
            continue
        train_seqs[uid] = items[:-2]
        row, ln = pad(items[:-2])
        v_users.append(uid); v_seqs.append(row); v_lens.append(ln)
        v_targets.append(items[-2])
        row, ln = pad(items[:-1])
        t_users.append(uid); t_seqs.append(row); t_lens.append(ln)
        t_targets.append(items[-1])

    train = build_sliding_windows(train_seqs, max_len=max_len, min_hist=min_hist)

    def pack(users, seqs, lens, targets):
        return {
            "user_id": np.asarray(users, dtype=np.int32),
            "item_seq": np.stack(seqs) if seqs else np.zeros((0, max_len), np.int32),
            "seq_len": np.asarray(lens, dtype=np.int32),
            "item_id": np.asarray(targets, dtype=np.int32),
        }

    return train, pack(v_users, v_seqs, v_lens, v_targets), \
        pack(t_users, t_seqs, t_lens, t_targets)
