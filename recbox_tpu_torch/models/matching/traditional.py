"""Traditional and closed-form recommenders: Pop, ItemKNN, EASE, PureSVD,
SLIM, ADMMSLIM, NCEPLRec.

Counterpart of `recbox_tpu/models/matching/traditional.py` (recbole's
0-epoch family and daisy's): no gradient training. `fit` computes the
statistics or the closed form with numpy on the host, from a dense
(num_users, num_items) float32 interaction matrix; `full_scores(user_rows)`
returns the (rows, num_items) score matrix as a tensor on the model's
device (the CUDA device unless ``device`` is named), and `topk_items`
serves the top k from it.

Precision: EASE's and ADMM-SLIM's inverses are taken in float64 (JAX's
in float32, so the weights differ at ~1e-5 relative); the rest is float32
like JAX. PureSVD's and NCEPLRec's factors carry a sign per component
(the SVD's), so only their scores are comparable across packages.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device

__all__ = ["Pop", "ItemKNN", "EASE", "PureSVD", "SLIM", "ADMMSLIM",
           "NCEPLRec", "build_interaction_matrix", "topk_items"]

Device = Optional[Union[str, torch.device]]


def build_interaction_matrix(user_ids, item_ids, num_users: int,
                             num_items: int) -> np.ndarray:
    """Dense multi-hot (num_users, num_items) float32 interaction rows."""
    X = np.zeros((num_users, num_items), dtype=np.float32)
    X[np.asarray(user_ids), np.asarray(item_ids)] = 1.0
    return X


class _Linear:
    """scores = X[rows] @ W on the device; subclasses set ``X`` and ``W``
    (numpy) in `fit` through `_place`."""

    def __init__(self, device: Device = None):
        self.device = resolve_device(device)

    def _place(self, X: np.ndarray, W: np.ndarray) -> None:
        self.X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        self.W = torch.as_tensor(np.asarray(W, np.float32), device=self.device)

    def full_scores(self, user_rows) -> torch.Tensor:
        rows = torch.as_tensor(np.asarray(user_rows), device=self.device)
        return self.X[rows.long()] @ self.W


class Pop:
    """Most-popular baseline: score = the item's train count."""

    def __init__(self, device: Device = None):
        self.device = resolve_device(device)

    def fit(self, user_ids, item_ids, num_users: int, num_items: int
            ) -> "Pop":
        counts = np.bincount(np.asarray(item_ids), minlength=num_items)
        self.scores = torch.as_tensor(counts.astype(np.float32),
                                      device=self.device)
        self.num_items = num_items
        return self

    def full_scores(self, user_rows) -> torch.Tensor:
        return self.scores[None, :].expand(len(user_rows), self.num_items)


class ItemKNN(_Linear):
    """Item-item cosine KNN: S = cos(XᵀX) without self-similarity, each
    target column keeping its ``topk`` nearest neighbours (ties at the
    threshold kept); scores = X·S."""

    def __init__(self, topk: int = 100, shrink: float = 0.0,
                 device: Device = None):
        super().__init__(device)
        self.topk = topk
        self.shrink = shrink

    def fit(self, user_ids, item_ids, num_users: int, num_items: int
            ) -> "ItemKNN":
        X = build_interaction_matrix(user_ids, item_ids, num_users,
                                     num_items)
        G = X.T @ X
        norms = np.sqrt(np.diagonal(G))
        S = G / (norms[:, None] * norms[None, :] + self.shrink + 1e-6)
        np.fill_diagonal(S, 0.0)
        if self.topk and self.topk < num_items:
            # the k-th largest of each row: S is symmetric, so it is the
            # column's threshold transposed
            thresh = -np.sort(-S, axis=1)[:, self.topk - 1]
            S = np.where(S >= thresh[None, :], S, 0.0)
        self._place(X, S)
        return self


class EASE(_Linear):
    """Embarrassingly shallow autoencoder, closed form: P = (XᵀX + λI)⁻¹,
    B = -P / diag(P) with diag(B) = 0; scores = X·B."""

    def __init__(self, reg_weight: float = 250.0, device: Device = None):
        super().__init__(device)
        self.reg_weight = reg_weight

    def fit(self, user_ids, item_ids, num_users: int, num_items: int
            ) -> "EASE":
        X = build_interaction_matrix(user_ids, item_ids, num_users,
                                     num_items)
        G = (X.T @ X).astype(np.float64) + self.reg_weight * np.eye(num_items)
        P = np.linalg.inv(G)
        B = -P / np.diagonal(P)[None, :]
        np.fill_diagonal(B, 0.0)
        self._place(X, B)
        return self


class PureSVD(_Linear):
    """Truncated-SVD CF: X ≈ U_k Σ_k V_kᵀ; scores = (X V_k) V_kᵀ."""

    def __init__(self, factors: int = 64, device: Device = None):
        super().__init__(device)
        self.factors = factors

    def fit(self, user_ids, item_ids, num_users: int, num_items: int
            ) -> "PureSVD":
        X = build_interaction_matrix(user_ids, item_ids, num_users,
                                     num_items)
        _, _, vt = np.linalg.svd(X, full_matrices=False)
        V = vt[:self.factors].T.astype(np.float32)
        self._place(X, V)
        self.V = self.W
        return self

    def full_scores(self, user_rows) -> torch.Tensor:
        return super().full_scores(user_rows) @ self.V.T


class SLIM(_Linear):
    """Sparse linear item model: per-item ElasticNet regressions X_i ≈ X W_i
    with W_ii = 0 (and W ≥ 0), by ``n_iters`` passes of proximal coordinate
    descent on the Gram matrix, one coordinate row across all targets at a
    time (JAX's order)."""

    def __init__(self, l1_reg: float = 1e-3, l2_reg: float = 1e-3,
                 n_iters: int = 30, positive_only: bool = True,
                 device: Device = None):
        super().__init__(device)
        self.l1 = l1_reg
        self.l2 = l2_reg
        self.n_iters = n_iters
        self.positive_only = positive_only

    def fit(self, user_ids, item_ids, num_users: int, num_items: int
            ) -> "SLIM":
        X = build_interaction_matrix(user_ids, item_ids, num_users,
                                     num_items)
        G = X.T @ X
        diag = np.diagonal(G).copy()
        l1 = np.float32(self.l1 * num_users)
        l2 = np.float32(self.l2 * num_users)
        W = np.zeros((num_items, num_items), np.float32)
        for _ in range(self.n_iters):
            for j in range(num_items):
                rho = G[j] - G[j] @ W + diag[j] * W[j]
                w = np.sign(rho) * np.maximum(np.abs(rho) - l1, 0.0) \
                    / (diag[j] + l2 + np.float32(1e-9))
                if self.positive_only:
                    w = np.maximum(w, 0.0)
                w[j] = 0.0
                W[j] = w
        self._place(X, W)
        return self


class ADMMSLIM(_Linear):
    """ADMM-SLIM: item-item weights by ADMM splitting with L1, L2 and a
    zero diagonal."""

    def __init__(self, lambda1: float = 1.0, lambda2: float = 10.0,
                 rho: float = 100.0, n_iters: int = 50,
                 positive_only: bool = True, device: Device = None):
        super().__init__(device)
        self.l1 = lambda1
        self.l2 = lambda2
        self.rho = rho
        self.n_iters = n_iters
        self.positive_only = positive_only

    def fit(self, user_ids, item_ids, num_users: int, num_items: int
            ) -> "ADMMSLIM":
        X = build_interaction_matrix(user_ids, item_ids, num_users,
                                     num_items)
        G = (X.T @ X).astype(np.float64)
        P = np.linalg.inv(G + (self.l2 + self.rho) * np.eye(num_items))
        off = 1.0 - np.eye(num_items)
        Z = np.zeros((num_items, num_items))
        Y = np.zeros((num_items, num_items))
        for _ in range(self.n_iters):
            B_hat = P @ (G + self.rho * (Z - Y))
            gamma = np.diagonal(B_hat) / np.maximum(np.diagonal(P), 1e-9)
            B = B_hat - P * gamma[None, :]
            U = B + Y
            Z = np.sign(U) * np.maximum(np.abs(U) - self.l1 / self.rho, 0.0)
            if self.positive_only:
                Z = np.maximum(Z, 0.0)
            Z = Z * off
            Y = Y + B - Z
        self._place(X, Z)
        return self


class NCEPLRec(_Linear):
    """NCE-PLRec: a rank-k SVD of the de-popularized matrix Q_ui = X_ui ·
    max(log(num_users / pop_i), 0); scores = X V_k Σ_k^(β-1) (ridge-damped)
    V_kᵀ."""

    def __init__(self, rank: int = 64, beta: float = 0.8,
                 reg_weight: float = 1e2, device: Device = None):
        super().__init__(device)
        self.rank = rank
        self.beta = beta
        self.reg_weight = reg_weight

    def fit(self, user_ids, item_ids, num_users: int, num_items: int
            ) -> "NCEPLRec":
        X = build_interaction_matrix(user_ids, item_ids, num_users,
                                     num_items)
        pop = np.maximum(X.sum(0), 1.0)
        Q = X * np.maximum(np.log(num_users / pop), 0.0)[None, :]
        _, s, vt = np.linalg.svd(Q, full_matrices=False)
        k = min(self.rank, len(s))
        V, s_k = vt[:k].T, s[:k]
        scale = np.power(np.maximum(s_k, 1e-9), self.beta - 1.0) \
            * (s_k ** 2 / (s_k ** 2 + self.reg_weight))
        self._place(X, V * scale[None, :])
        self.V = torch.as_tensor(V.astype(np.float32), device=self.device)
        return self

    def full_scores(self, user_rows) -> torch.Tensor:
        return super().full_scores(user_rows) @ self.V.T


def topk_items(model, user_rows, topk: int,
               mask_seen: Optional[torch.Tensor] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(scores, ids) of each row's top k as numpy, items where
    ``mask_seen`` > 0 scored -1e9 first."""
    scores = model.full_scores(user_rows)
    if mask_seen is not None:
        mask = torch.as_tensor(np.asarray(mask_seen), device=scores.device)
        scores = torch.where(mask > 0, torch.tensor(
            -1e9, dtype=scores.dtype, device=scores.device), scores)
    s, i = torch.topk(scores, topk, dim=1)
    return s.cpu().numpy(), i.cpu().numpy()
