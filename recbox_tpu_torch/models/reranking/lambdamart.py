"""LambdaMART initial ranker: gradient-boosted regression trees fit to
NDCG lambda gradients, in numpy float64 on the host.

Copy of `recbox_tpu/models/reranking/lambdamart.py` (`_RegressionTree`
:32, `_lambdas_for_query` :91, `LambdaMART` :124): the same operations in
the same order, so on the same inputs its lambdas, trees, predictions and
``ndcg`` are bit for bit the JAX package's. The JAX package runs it on the
host, and so does the port: building trees is branchy and sequential work
with nothing for the card. The lambdas are vectorised per query (pairwise
ΔNDCG matrices); the tree builder is an exact-greedy split over
percentile thresholds; inference walks the forest.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["LambdaMART"]


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class _RegressionTree:
    """Exact-greedy regression tree over percentile-candidate thresholds."""

    def __init__(self, max_depth: int = 4, min_samples_leaf: int = 8,
                 n_thresholds: int = 16):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.n_thresholds = n_thresholds
        self.nodes: List[_Node] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "_RegressionTree":
        self.nodes = []
        self._build(X, y, np.arange(len(y)), depth=0)
        return self

    def _build(self, X, y, idx, depth) -> int:
        node_id = len(self.nodes)
        self.nodes.append(_Node(value=float(np.mean(y[idx]))))
        if depth >= self.max_depth or len(idx) < 2 * self.min_samples_leaf:
            return node_id
        best = (0.0, -1, 0.0)  # (gain, feature, threshold)
        base = np.sum(y[idx]) ** 2 / len(idx)
        for f in range(X.shape[1]):
            xs = X[idx, f]
            qs = np.unique(np.percentile(
                xs, np.linspace(5, 95, self.n_thresholds)))
            for t in qs:
                left = xs <= t
                nl = left.sum()
                nr = len(idx) - nl
                if nl < self.min_samples_leaf or nr < self.min_samples_leaf:
                    continue
                sl = np.sum(y[idx[left]])
                sr = np.sum(y[idx[~left]])
                gain = sl * sl / nl + sr * sr / nr - base
                if gain > best[0]:
                    best = (gain, f, float(t))
        if best[1] < 0:
            return node_id
        _, f, t = best
        left_idx = idx[X[idx, f] <= t]
        right_idx = idx[X[idx, f] > t]
        self.nodes[node_id].feature = f
        self.nodes[node_id].threshold = t
        self.nodes[node_id].left = self._build(X, y, left_idx, depth + 1)
        self.nodes[node_id].right = self._build(X, y, right_idx, depth + 1)
        return node_id

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.zeros(len(X))
        for i, x in enumerate(X):
            n = 0
            while self.nodes[n].feature >= 0:
                n = (self.nodes[n].left if x[self.nodes[n].feature]
                     <= self.nodes[n].threshold else self.nodes[n].right)
            out[i] = self.nodes[n].value
        return out


def _lambdas_for_query(scores: np.ndarray, rel: np.ndarray,
                       sigma: float = 1.0) -> np.ndarray:
    """Vectorized LambdaRank gradients with |ΔNDCG| weighting
    (`ranker.py` compute_lambda, without the per-pair Python loop)."""
    n = len(scores)
    if n < 2 or rel.max() == rel.min():
        return np.zeros(n)
    order = np.argsort(-scores)
    rank = np.empty(n, int)
    rank[order] = np.arange(n)
    gain = (2.0 ** rel - 1.0)
    disc = 1.0 / np.log2(rank + 2.0)
    ideal = np.sort(gain)[::-1]
    idcg = np.sum(ideal / np.log2(np.arange(n) + 2.0))
    if idcg <= 0:
        return np.zeros(n)
    # pairwise |ΔNDCG| for swapping i, j
    delta = np.abs((gain[:, None] - gain[None, :])
                   * (disc[:, None] - disc[None, :])) / idcg
    s_diff = scores[:, None] - scores[None, :]
    sign = np.sign(rel[:, None] - rel[None, :])
    # rho is oriented by the RELEVANCE ordering: for the (more-rel,
    # less-rel) pair, rho = 1/(1+e^{σ(s_more − s_less)}) — near 0 when the
    # pair is already correctly ordered with margin, 1 when inverted — and
    # the SAME rho applies to both members (λ_j = −λ_i, antisymmetric).
    # A row-oriented rho (1/(1+e^{σ(s_i−s_j)})) gives the less-relevant
    # doc 1−rho instead: maximal push-down exactly on correctly-ordered
    # pairs and ~zero on inverted ones.
    rho = 1.0 / (1.0 + np.exp(np.clip(sigma * sign * s_diff, -60, 60)))
    lam = sigma * delta * rho * sign
    return lam.sum(axis=1)


class LambdaMART:
    """Gradient-boosted LambdaRank (`ranker.py:126-368` shape)."""

    def __init__(self, n_trees: int = 30, learning_rate: float = 0.1,
                 max_depth: int = 4, min_samples_leaf: int = 8):
        self.n_trees = n_trees
        self.lr = learning_rate
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.trees: List[_RegressionTree] = []

    def fit(self, X: np.ndarray, rel: np.ndarray, qid: np.ndarray,
            valid_every: int = 0) -> "LambdaMART":
        X = np.asarray(X, np.float64)
        rel = np.asarray(rel, np.float64)
        qid = np.asarray(qid)
        scores = np.zeros(len(X))
        groups = [np.flatnonzero(qid == q) for q in np.unique(qid)]
        self.trees = []
        for _ in range(self.n_trees):
            lam = np.zeros(len(X))
            for g in groups:
                lam[g] = _lambdas_for_query(scores[g], rel[g])
            tree = _RegressionTree(self.max_depth, self.min_samples_leaf)
            tree.fit(X, lam)
            scores += self.lr * tree.predict(X)
            self.trees.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        out = np.zeros(len(X))
        for tree in self.trees:
            out += self.lr * tree.predict(X)
        return out

    def ndcg(self, X, rel, qid, k: int = 10) -> float:
        scores = self.predict(X)
        vals = []
        for q in np.unique(qid):
            g = np.flatnonzero(qid == q)
            order = np.argsort(-scores[g])
            gains = (2.0 ** rel[g][order] - 1.0)[:k]
            dcg = np.sum(gains / np.log2(np.arange(len(gains)) + 2.0))
            ideal = np.sort(2.0 ** rel[g] - 1.0)[::-1][:k]
            idcg = np.sum(ideal / np.log2(np.arange(len(ideal)) + 2.0))
            if idcg > 0:
                vals.append(dcg / idcg)
        return float(np.mean(vals)) if vals else 0.0
