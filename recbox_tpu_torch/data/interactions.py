"""Interaction dataset processing: filtering, remapping, ordering, splitting.

Numpy re-design of recbole's atomic Dataset pipeline
(`third_party/recbole/data/dataset/dataset.py:44-2161`) and daisy's
Preprocessor/splitters (`third_party/daisy/utils/{loader,splitter}.py`):

* k-core filtering — iterative min-interaction pruning of users/items
  (`dataset.py:868-930` `_filter_by_inter_num`);
* value filtering / label binarization by rating threshold
  (`dataset.py:932-1010`, daisy `Preprocessor` binarize);
* contiguous ID remapping (`dataset.py:1165-1230` `_remap_ID_all`);
* ordering: RO (random shuffle) / TO (time sort) and splitting: RS (ratio
  split, optionally grouped by user) / LS (leave-one-out per user)
  (`dataset.py:1746-1807` `build()`, daisy `splitter.py:29-160`).

Everything is columnar numpy; the output feeds FeatureEncoder / loaders.
Own copy of `recbox_tpu/data/interactions.py`; a malformed input raises
ValueError where the JAX copy asserts.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["InteractionDataset"]


class InteractionDataset:
    """Columnar (user, item[, rating, timestamp]) interaction table."""

    def __init__(self, user_ids, item_ids, ratings=None, timestamps=None,
                 extra: Optional[Dict[str, np.ndarray]] = None):
        self.user_ids = np.asarray(user_ids)
        self.item_ids = np.asarray(item_ids)
        self.ratings = None if ratings is None else np.asarray(ratings)
        self.timestamps = None if timestamps is None else np.asarray(timestamps)
        self.extra = {k: np.asarray(v) for k, v in (extra or {}).items()}
        self.user_map: Dict = {}
        self.item_map: Dict = {}
        if len(self.item_ids) != len(self.user_ids):
            raise ValueError(f"{len(self.user_ids)} user ids, "
                             f"{len(self.item_ids)} item ids")

    def __len__(self) -> int:
        return len(self.user_ids)

    def _select(self, mask: np.ndarray) -> "InteractionDataset":
        ds = InteractionDataset(
            self.user_ids[mask], self.item_ids[mask],
            None if self.ratings is None else self.ratings[mask],
            None if self.timestamps is None else self.timestamps[mask],
            {k: v[mask] for k, v in self.extra.items()})
        ds.user_map, ds.item_map = self.user_map, self.item_map
        return ds

    # -- filtering -----------------------------------------------------------
    def filter_by_count(self, min_user_inter: int = 0,
                        min_item_inter: int = 0) -> "InteractionDataset":
        """Iterative k-core pruning until both minimums hold
        (`_filter_by_inter_num` semantics)."""
        ds = self
        while True:
            u_vals, u_counts = np.unique(ds.user_ids, return_counts=True)
            i_vals, i_counts = np.unique(ds.item_ids, return_counts=True)
            bad_u = set(u_vals[u_counts < min_user_inter])
            bad_i = set(i_vals[i_counts < min_item_inter])
            if not bad_u and not bad_i:
                return ds
            keep = ~(np.isin(ds.user_ids,
                             np.fromiter(bad_u, ds.user_ids.dtype,
                                         len(bad_u)))
                     | np.isin(ds.item_ids,
                               np.fromiter(bad_i, ds.item_ids.dtype,
                                           len(bad_i))))
            ds = ds._select(keep)
            if len(ds) == 0:
                return ds

    def filter_by_rating(self, min_rating: float) -> "InteractionDataset":
        if self.ratings is None:
            raise ValueError("no rating column")
        return self._select(self.ratings >= min_rating)

    def binarize(self, threshold: float) -> "InteractionDataset":
        """rating → {0,1} label by threshold (recbole label-by-threshold,
        daisy positive_threshold)."""
        if self.ratings is None:
            raise ValueError("no rating column")
        ds = self._select(np.ones(len(self), bool))
        ds.ratings = (self.ratings >= threshold).astype(np.float32)
        return ds

    # -- remapping -----------------------------------------------------------
    def remap_ids(self, start: int = 0) -> "InteractionDataset":
        """Map raw user/item ids to contiguous ints start..start+n−1 in
        SORTED raw-id order (deterministic, like recbole's remap).

        Use ``start=1`` when the result feeds the SEQUENTIAL pipeline
        (`data/sequential.py`) or any padded consumer: id 0 is the framework
        PAD, and a real item remapped to 0 would be indistinguishable from
        left-padding (masked out of attention and targets)."""
        u_vals, u_new = np.unique(self.user_ids, return_inverse=True)
        i_vals, i_new = np.unique(self.item_ids, return_inverse=True)
        ds = InteractionDataset(
            (u_new + start).astype(np.int32),
            (i_new + start).astype(np.int32), self.ratings,
            self.timestamps, self.extra)
        ds.user_map = {v: k + start for k, v in enumerate(u_vals.tolist())}
        ds.item_map = {v: k + start for k, v in enumerate(i_vals.tolist())}
        return ds

    @property
    def num_users(self) -> int:
        return int(self.user_ids.max()) + 1 if len(self) else 0

    @property
    def num_items(self) -> int:
        return int(self.item_ids.max()) + 1 if len(self) else 0

    # -- ordering + splitting -------------------------------------------------
    def _order(self, how: str, rng: np.random.Generator) -> np.ndarray:
        if how == "RO":
            idx = np.arange(len(self))
            rng.shuffle(idx)
            return idx
        if how == "TO":
            if self.timestamps is None:
                raise ValueError("TO ordering needs timestamps")
            return np.argsort(self.timestamps, kind="mergesort")
        raise ValueError(f"ordering {how!r} (use 'RO' or 'TO')")

    def split_ratio(self, ratios: Sequence[float] = (0.8, 0.1, 0.1),
                    order: str = "RO", group_by_user: bool = False,
                    seed: int = 2024) -> Tuple["InteractionDataset", ...]:
        """RS split after RO/TO ordering, optionally per-user grouped
        (`dataset.py:1756-1790`)."""
        rng = np.random.default_rng(seed)
        if abs(sum(ratios) - 1.0) >= 1e-6:
            raise ValueError(f"split ratios {tuple(ratios)} do not sum to 1")
        idx = self._order(order, rng)

        def split_counts(n):
            # remainder goes to the FIRST part (train), recbole
            # `dataset.py:1600-1620` _calcu_split_ids
            cnt = [int(r * n) for r in ratios]
            cnt[0] = n - sum(cnt[1:])
            return np.cumsum(cnt)[:-1]

        if not group_by_user:
            parts = np.split(idx, split_counts(len(idx)))
        else:
            parts = [[] for _ in ratios]
            u_sorted = idx[np.argsort(self.user_ids[idx], kind="mergesort")]
            users = self.user_ids[u_sorted]
            boundary = np.ones(len(users), bool)
            boundary[1:] = users[1:] != users[:-1]
            starts = np.flatnonzero(boundary)
            for s, e in zip(starts, np.append(starts[1:], len(users))):
                rows = u_sorted[s:e]
                for part, chunk in zip(parts, np.split(rows, split_counts(len(rows)))):
                    part.extend(chunk.tolist())
            parts = [np.asarray(p, dtype=np.int64) for p in parts]
        return tuple(self._select_by_index(p) for p in parts)

    def _select_by_index(self, rows: np.ndarray) -> "InteractionDataset":
        mask = np.zeros(len(self), bool)
        mask[np.asarray(rows, dtype=np.int64)] = True
        return self._select(mask)

    def split_leave_one_out(self, order: str = "TO",
                            seed: int = 2024) -> Tuple["InteractionDataset", ...]:
        """LS: per user, last interaction → test, second-to-last → valid
        (`dataset.py:1791-1807`)."""
        rng = np.random.default_rng(seed)
        if order == "TO" and self.timestamps is None:
            # silent fallback to random order would change the documented
            # temporal protocol; require the caller to opt in explicitly
            raise ValueError("split_leave_one_out(order='TO') needs "
                             "timestamps; pass order='RO' for random order")
        idx = self._order(order, rng)
        users = self.user_ids[idx]
        order_sorted = idx[np.argsort(users, kind="mergesort")]
        users = self.user_ids[order_sorted]
        boundary = np.ones(len(users), bool)
        boundary[1:] = users[1:] != users[:-1]
        starts = np.flatnonzero(boundary)
        train_rows, valid_rows, test_rows = [], [], []
        for s, e in zip(starts, np.append(starts[1:], len(users))):
            rows = order_sorted[s:e]
            if len(rows) >= 3:
                train_rows.extend(rows[:-2])
                valid_rows.append(rows[-2])
                test_rows.append(rows[-1])
            else:
                train_rows.extend(rows)
        return (self._select_by_index(np.asarray(train_rows)),
                self._select_by_index(np.asarray(valid_rows)),
                self._select_by_index(np.asarray(test_rows)))

    # -- export ---------------------------------------------------------------
    def user2items(self) -> Dict[int, list]:
        out: Dict[int, list] = {}
        for u, i in zip(self.user_ids, self.item_ids):
            out.setdefault(int(u), []).append(int(i))
        return out

    def arrays(self, user_col: str = "user_id",
               item_col: str = "item_id") -> Dict[str, np.ndarray]:
        out = {user_col: self.user_ids.astype(np.int32),
               item_col: self.item_ids.astype(np.int32)}
        if self.ratings is not None:
            out["label"] = self.ratings.astype(np.float32)
        if self.timestamps is not None:
            out["timestamp"] = self.timestamps
        out.update(self.extra)
        return out
