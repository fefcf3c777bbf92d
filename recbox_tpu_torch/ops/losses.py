"""Training losses of the ported slices.

Counterpart of `recbox_tpu/ops/losses.py` `binary_crossentropy` (:87-98)
and `embedding_reg_loss` (:100-118). The matching and softmax losses of that
file are not ported yet (`ROADMAP.md`).
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch
import torch.nn.functional as F

from recbox_tpu_torch import resolve_device

__all__ = ["binary_crossentropy", "embedding_reg_loss"]

_EPS = 1e-7


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
