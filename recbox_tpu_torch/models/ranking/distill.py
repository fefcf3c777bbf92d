"""KD_DAGFM: the knowledge-distilled directed-acyclic-graph FM.

Counterpart of `recbox_tpu/models/ranking/distill.py`: the student DAGFM
propagates field states over a learned complete field graph for
``n_layers`` layers (x^{l+1} = (Σ_j w^l_{j→i} ⊙ x^l_j) ⊙ x^0 + x^l, with
'inner' (F, F, D) kernels ``w<l>`` or low-rank 'outer' ones ``p<l>``
(F, F, D, r) / ``q<l>`` (F, F, r, D), flax's xavier_normal at flax's fans)
and reads the layer sums through ``head``. KD_DAGFM is the same network
under the reference's registered name; `distillation_loss` is the
schedule's loss (teacher logits held fixed).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.ranking.ctr import _dense, _FieldModel
from recbox_tpu_torch.nn.core import xavier_normal_

__all__ = ["DAGFM", "KD_DAGFM", "distillation_loss"]


class DAGFM(_FieldModel):
    """The student network: field-graph propagation with elementwise
    ('inner') or low-rank outer kernels, the concatenated layer sums under
    ``head``."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 n_layers: int = 3, kernel_type: str = "inner",
                 rank: int = 8, compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        if kernel_type not in ("inner", "outer"):
            raise ValueError(f"kernel_type={kernel_type!r}")
        self.n_layers, self.kernel_type = n_layers, kernel_type
        f, d = self.n_fields, embedding_dim
        shapes = {"w": (f, f, d)} if kernel_type == "inner" \
            else {"p": (f, f, d, rank), "q": (f, f, rank, d)}
        for i in range(n_layers):
            for name, shape in shapes.items():
                t = torch.empty(shape, device=self._dev)
                xavier_normal_(t, self._gen)
                self.register_parameter(f"{name}{i}", nn.Parameter(t))
        self.head = _dense(d * (n_layers + 1), 1, True, self._gen,
                           self._dev, xavier=True)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        x, outs = field, [torch.sum(field, dim=1)]
        for i in range(self.n_layers):
            if self.kernel_type == "inner":
                w = getattr(self, f"w{i}").to(x.dtype)
                x = torch.einsum("bfd,fgd->bgd", x, w) * field + x
            else:
                p = getattr(self, f"p{i}").to(x.dtype)
                q = getattr(self, f"q{i}").to(x.dtype)
                x = torch.einsum("bfd,fgdr,fgre->bge", x, p, q) * field + x
            outs.append(torch.sum(x, dim=1))
        return self.head(torch.cat(outs, dim=-1).float()).reshape(-1)


class KD_DAGFM(DAGFM):
    """DAGFM under the reference's registered name; the distillation
    schedule (teacher forward → `distillation_loss` → CTR fine-tune) lives
    in the training loop."""


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor,
                      labels: Optional[torch.Tensor] = None,
                      alpha: float = 0.9) -> torch.Tensor:
    """α · MSE(student, teacher logits) + (1 − α) · BCE(student, labels);
    the pure distillation term without labels. The teacher's logits carry
    no gradient."""
    kd = torch.mean(torch.square(student_logits - teacher_logits.detach()))
    if labels is None:
        return kd
    bce = torch.mean(torch.logaddexp(student_logits,
                                     torch.zeros_like(student_logits))
                     - labels * student_logits)
    return alpha * kd + (1.0 - alpha) * bce
