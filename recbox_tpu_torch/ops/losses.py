"""Training losses: the matching losses, CTR's and the regularizers.

Counterpart of `recbox_tpu/ops/losses.py`. The matching losses take a
score matrix ``y_pred`` (B, 1 + num_negs) with the positive in column 0
(`MatchingLoader`'s layout): `cosine_contrastive_loss`,
`mse_matching_loss`, `pairwise_logistic_loss` (BPR over sampled
negatives), `pairwise_margin_loss`, `sigmoid_crossentropy_loss` (a sum),
`softmax_crossentropy_loss`, recbole's `bpr_loss`, and the registries
`get_matching_loss` (by the reference's class names) and
`get_ranking_loss`; then `binary_crossentropy`, `embedding_reg_loss` and
`full_softmax_loss`. Each is JAX's formula in JAX's op order.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import torch
import torch.nn.functional as F

from recbox_tpu_torch import resolve_device

__all__ = [
    "cosine_contrastive_loss", "mse_matching_loss", "pairwise_logistic_loss",
    "pairwise_margin_loss", "sigmoid_crossentropy_loss",
    "softmax_crossentropy_loss", "bpr_loss", "binary_crossentropy",
    "embedding_reg_loss", "full_softmax_loss", "get_matching_loss",
    "get_ranking_loss",
]

_EPS = 1e-7


def cosine_contrastive_loss(y_pred: torch.Tensor, margin: float = 0.0,
                            negative_weight: Optional[float] = None
                            ) -> torch.Tensor:
    """relu(1 - pos) + the sum of relu(neg - margin) (their mean times
    ``negative_weight`` when given), averaged over rows."""
    pos = F.relu(1.0 - y_pred[:, 0])
    neg = F.relu(y_pred[:, 1:] - margin)
    if negative_weight is not None:
        loss = pos + torch.mean(neg, dim=-1) * negative_weight
    else:
        loss = pos + torch.sum(neg, dim=-1)
    return torch.mean(loss)


def mse_matching_loss(y_pred: torch.Tensor) -> torch.Tensor:
    """(pos - 1)² / 2 + the sum of neg² / 2, averaged over rows."""
    pos = torch.square(y_pred[:, 0] - 1.0) / 2.0
    neg = torch.sum(torch.square(y_pred[:, 1:]), dim=-1) / 2.0
    return torch.mean(pos + neg)


def pairwise_logistic_loss(y_pred: torch.Tensor) -> torch.Tensor:
    """BPR over sampled negatives: softplus(neg - pos), i.e. -log σ(pos -
    neg), averaged over every (row, negative) pair."""
    diff = y_pred[:, :1] - y_pred[:, 1:]
    return torch.mean(F.softplus(-diff))


def pairwise_margin_loss(y_pred: torch.Tensor, margin: float = 1.0
                         ) -> torch.Tensor:
    """Hinge: relu(margin + neg - pos), averaged over pairs."""
    return torch.mean(F.relu(margin + y_pred[:, 1:] - y_pred[:, :1]))


def sigmoid_crossentropy_loss(y_pred: torch.Tensor) -> torch.Tensor:
    """BCE with logits, column 0 labelled 1 and the rest 0, summed."""
    labels = torch.zeros_like(y_pred)
    labels[:, 0] = 1.0
    return torch.sum(F.softplus(y_pred) - labels * y_pred)


def softmax_crossentropy_loss(y_pred: torch.Tensor) -> torch.Tensor:
    """Sampled softmax CE on column 0, averaged over rows."""
    return -torch.mean(torch.log_softmax(y_pred, dim=1)[:, 0])


def bpr_loss(pos_score: torch.Tensor, neg_score: torch.Tensor,
             gamma: float = 1e-10) -> torch.Tensor:
    """recbole's BPRLoss: -log(gamma + σ(pos - neg)), averaged."""
    return -torch.mean(torch.log(gamma + torch.sigmoid(pos_score
                                                       - neg_score)))


def binary_crossentropy(logits: torch.Tensor, labels: torch.Tensor,
                        from_logits: bool = True) -> torch.Tensor:
    """Mean BCE for CTR ranking heads, in the logits' dtype and device."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    if from_logits:
        per = F.softplus(logits) - labels * logits
    else:
        p = torch.clamp(logits, _EPS, 1.0 - _EPS)
        per = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return torch.mean(per)


def embedding_reg_loss(params: Mapping[str, torch.Tensor], p: int = 2,
                       prefix: str = "emb_",
                       device: Optional[Union[str, torch.device]] = None
                       ) -> torch.Tensor:
    """(1/p) · Σ ||W||_p^p over the params whose name has a '/'-separated
    component starting with ``prefix`` ('' takes every param). ``params``
    maps JAX-style names (``embedding/emb_c0``) to tensors. With no match
    the result is a zero on ``device`` (the CUDA device unless one is
    named)."""
    leaves = [v for k, v in params.items()
              if any(part.startswith(prefix) for part in k.split("/"))]
    if not leaves:
        return torch.zeros((), device=resolve_device(device))
    return sum(torch.sum(torch.abs(v) ** p) for v in leaves) / p


def full_softmax_loss(full_scores: torch.Tensor,
                      target_ids: torch.Tensor) -> torch.Tensor:
    """CE over the full item vocabulary (recbole loss_type='CE'):
    full_scores (B, vocab), target_ids (B,) int; the mean over rows of
    -log_softmax(scores)[target]. Under a mesh, a model's ``full_scores``
    over a row-sharded table are `parallel.mesh.ShardedLogits`, whose CE
    is the vocabulary-parallel one (`parallel.mesh.vocab_parallel_ce`)."""
    from recbox_tpu_torch.parallel.mesh import (
        ShardedLogits, vocab_parallel_ce,
    )
    if isinstance(full_scores, ShardedLogits):
        return vocab_parallel_ce(full_scores, target_ids)
    logp = torch.log_softmax(full_scores, dim=-1)
    return -torch.mean(torch.gather(
        logp, 1, target_ids.reshape(-1, 1).to(torch.int64))[:, 0])


_MATCHING_LOSSES = {
    "CosineContrastiveLoss": cosine_contrastive_loss,
    "MSELoss": lambda y, **kw: mse_matching_loss(y),
    "PairwiseLogisticLoss": lambda y, **kw: pairwise_logistic_loss(y),
    "PairwiseMarginLoss": pairwise_margin_loss,
    "SigmoidCrossEntropyLoss": lambda y, **kw: sigmoid_crossentropy_loss(y),
    "SoftmaxCrossEntropyLoss": lambda y, **kw: softmax_crossentropy_loss(y),
}


def get_matching_loss(name: str, **kwargs
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A matching loss by the reference's class name, its keyword arguments
    bound (the losses without options ignore them, as in JAX)."""
    if name not in _MATCHING_LOSSES:
        raise NotImplementedError(f"matching loss {name}")
    fn = _MATCHING_LOSSES[name]
    return lambda y_pred: fn(y_pred, **kwargs)


def get_ranking_loss(name: str) -> Callable:
    """'binary_crossentropy' / 'bce' / 'logloss', or 'mse' /
    'mean_squared_error', any case."""
    name = name.lower()
    if name in ("binary_crossentropy", "bce", "logloss"):
        return binary_crossentropy
    if name in ("mse", "mean_squared_error"):
        return lambda logits, labels: torch.mean(torch.square(
            logits.reshape(-1) - labels.reshape(-1)))
    raise NotImplementedError(f"ranking loss {name}")
