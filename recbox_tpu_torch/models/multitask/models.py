"""Multi-task CTR models: SharedBottom, MMOE, PLE, ESMM, AITM.

Counterpart of `recbox_tpu/models/multitask/models.py` (`multitask_loss`
:31, `_BatchedExperts` :61, the models :77-227). A model maps a batch to
(B, T) outputs ordered as ``feature_map.labels``: logits, except ESMM's
probabilities (pCTR, pCTCVR = pCTR · pCVR; its ``output_type`` is
'probs', and its loss and evaluator take ``from_logits=False``). The
features are embedded and pooled as the CTR zoo's (``embedding``) and
concatenated flat. The E experts of a mixture are one batched einsum a
layer over (E, in, out) kernels (``w<i>``, flax's xavier_normal at flax's
fans, which count E as a receptive field) and (E, out) biases (``b<i>``).
Submodules carry the flax names (``bottom``, ``tower_<t>``, ``experts``,
``gate_<t>``, ``l<level>_task<t>_experts``, ``l<level>_shared_experts``,
``l<level>_gate<t>``, ``l<level>_shared_gate``, ``ctr_tower``,
``cvr_tower``, ``transfer_<t>``, ``q<t>`` / ``k<t>`` / ``v<t>``,
``head_<t>``) for `interop.from_jax_params`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import RankingModel
from recbox_tpu_torch.nn.attention import dense
from recbox_tpu_torch.nn.core import MLP, xavier_normal_
from recbox_tpu_torch.nn.embedding import FeatureEmbedding, concat_embeddings

__all__ = ["SharedBottom", "MMOE", "PLE", "ESMM", "AITM", "multitask_loss"]

Device = Optional[Union[str, torch.device]]


def multitask_loss(outputs: torch.Tensor, labels: torch.Tensor,
                   weights=None, from_logits: bool = True) -> torch.Tensor:
    """Σ_t w_t · BCE(outputs[:, t], labels[:, t]), equal weights by
    default; ``from_logits=False`` reads probabilities, clipped to
    [1e-7, 1 − 1e-7]."""
    labels = labels.to(outputs.dtype)
    if from_logits:
        per = torch.logaddexp(outputs, torch.zeros_like(outputs)) \
            - labels * outputs
    else:
        p = torch.clamp(outputs, 1e-7, 1 - 1e-7)
        per = -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))
    per_task = torch.mean(per, dim=0)
    if weights is not None:
        per_task = per_task * torch.as_tensor(
            weights, dtype=outputs.dtype, device=outputs.device)
    return torch.sum(per_task)


class _BatchedExperts(nn.Module):
    """E parallel relu MLPs as stacked einsums: (B, D) → (B, E, H)."""

    def __init__(self, in_dim: int, num_experts: int,
                 hidden_units: Sequence[int], generator, device):
        super().__init__()
        self.num_experts = num_experts
        self.n_layers = len(hidden_units)
        for i, units in enumerate(hidden_units):
            w = torch.empty(num_experts, in_dim, units, device=device)
            xavier_normal_(w, generator)
            self.register_parameter(f"w{i}", nn.Parameter(w))
            self.register_parameter(f"b{i}", nn.Parameter(
                torch.zeros(num_experts, units, device=device)))
            in_dim = units
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :].expand(-1, self.num_experts, -1)
        for i in range(self.n_layers):
            h = F.relu(torch.einsum("bed,edu->beu", h, getattr(self, f"w{i}"))
                       + getattr(self, f"b{i}"))
        return h


class _MTLBase(RankingModel):
    """The pooled ``embedding`` flat; `forward` returns the (B, T)
    outputs."""

    output_type = "logits"

    def __init__(self, feature_map: FeatureMap, embedding_dim: int,
                 generator: Optional[torch.Generator], device: Device):
        super().__init__(feature_map)
        self._gen, self._dev = self.init_rng(generator, device)
        self.embedding_dim = embedding_dim
        self.num_tasks = len(feature_map.labels)
        self.embedding = FeatureEmbedding(
            feature_map, embedding_dim=embedding_dim, name="embedding",
            generator=self._gen, device=self._dev)
        self.in_dim = self.embedding.out_dim

    def _mlp(self, in_dim: int, hidden_units, **kw) -> MLP:
        return MLP(in_dim, tuple(hidden_units), generator=self._gen,
                   device=self._dev, **kw)

    def _experts(self, in_dim: int, n: int, units) -> _BatchedExperts:
        return _BatchedExperts(in_dim, n, tuple(units), self._gen, self._dev)

    def _gate(self, in_dim: int, n: int) -> nn.Linear:
        return dense(in_dim, n, self._gen, self._dev, bias=False)

    def _embed_flat(self, batch) -> torch.Tensor:
        return concat_embeddings(self.embedding(batch),
                                 self.feature_map.input_features)

    def forward(self, batch) -> torch.Tensor:
        return self.logits(batch)


def _mix(experts: torch.Tensor, gate: nn.Linear, x: torch.Tensor
         ) -> torch.Tensor:
    return torch.einsum("beh,be->bh", experts,
                        torch.softmax(gate(x), dim=-1))


class SharedBottom(_MTLBase):
    """A shared MLP bottom and a tower a task."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 bottom_units: Sequence[int] = (256, 128),
                 tower_units: Sequence[int] = (64,), dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, generator, device)
        self.bottom = self._mlp(self.in_dim, bottom_units, dropout=dropout)
        for t in range(self.num_tasks):
            self.add_module(f"tower_{t}", self._mlp(
                self.bottom.out_dim, tower_units, output_dim=1,
                dropout=dropout))

    def logits(self, batch) -> torch.Tensor:
        bottom = self.bottom(self._embed_flat(batch))
        return torch.cat([getattr(self, f"tower_{t}")(bottom)
                          for t in range(self.num_tasks)], dim=-1)


class MMOE(_MTLBase):
    """Multi-gate mixture of experts: shared experts, a softmax gate and a
    tower a task."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 num_experts: int = 4,
                 expert_units: Sequence[int] = (256, 128),
                 tower_units: Sequence[int] = (64,), dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, generator, device)
        self.experts = self._experts(self.in_dim, num_experts, expert_units)
        for t in range(self.num_tasks):
            self.add_module(f"gate_{t}", self._gate(self.in_dim, num_experts))
            self.add_module(f"tower_{t}", self._mlp(
                self.experts.out_dim, tower_units, output_dim=1,
                dropout=dropout))

    def logits(self, batch) -> torch.Tensor:
        x = self._embed_flat(batch)
        experts = self.experts(x)
        return torch.cat([
            getattr(self, f"tower_{t}")(
                _mix(experts, getattr(self, f"gate_{t}"), x))
            for t in range(self.num_tasks)], dim=-1)


class PLE(_MTLBase):
    """Progressive layered extraction: task-specific and shared experts
    under customized gates, ``num_levels`` deep; the last level has no
    shared gate (its mixture would feed nothing)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 num_levels: int = 1, specific_experts: int = 2,
                 shared_experts: int = 2,
                 expert_units: Sequence[int] = (128,),
                 tower_units: Sequence[int] = (64,), dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, generator, device)
        self.num_levels = num_levels
        n_tasks, width = self.num_tasks, self.in_dim
        for lv in range(num_levels):
            for t in range(n_tasks):
                self.add_module(f"l{lv}_task{t}_experts", self._experts(
                    width, specific_experts, expert_units))
            self.add_module(f"l{lv}_shared_experts", self._experts(
                width, shared_experts, expert_units))
            for t in range(n_tasks):
                self.add_module(f"l{lv}_gate{t}", self._gate(
                    width, specific_experts + shared_experts))
            if lv < num_levels - 1:
                self.add_module(f"l{lv}_shared_gate", self._gate(
                    width, n_tasks * specific_experts + shared_experts))
            width = tuple(expert_units)[-1]
        for t in range(n_tasks):
            self.add_module(f"tower_{t}", self._mlp(
                width, tower_units, output_dim=1, dropout=dropout))

    def logits(self, batch) -> torch.Tensor:
        x = self._embed_flat(batch)
        n_tasks = self.num_tasks
        task_inputs, shared_input = [x] * n_tasks, x
        for lv in range(self.num_levels):
            task_out = [getattr(self, f"l{lv}_task{t}_experts")(
                task_inputs[t]) for t in range(n_tasks)]
            shared_out = getattr(self, f"l{lv}_shared_experts")(shared_input)
            new_inputs = [_mix(torch.cat([task_out[t], shared_out], dim=1),
                               getattr(self, f"l{lv}_gate{t}"),
                               task_inputs[t]) for t in range(n_tasks)]
            if lv < self.num_levels - 1:
                shared_input = _mix(torch.cat(task_out + [shared_out], dim=1),
                                    getattr(self, f"l{lv}_shared_gate"),
                                    shared_input)
            task_inputs = new_inputs
        return torch.cat([getattr(self, f"tower_{t}")(task_inputs[t])
                          for t in range(n_tasks)], dim=-1)


class ESMM(_MTLBase):
    """Entire-space multi-task model over labels (ctr, ctcvr): outputs
    (pCTR, pCTR · pCVR), probabilities."""

    output_type = "probs"

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 tower_units: Sequence[int] = (128, 64),
                 dropout: float = 0.0, output_type: str = "probs",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, generator, device)
        if self.num_tasks != 2:
            raise ValueError(f"ESMM needs (ctr, ctcvr) labels, got "
                             f"{feature_map.labels}")
        self.output_type = output_type
        self.ctr_tower = self._mlp(self.in_dim, tower_units, output_dim=1,
                                   dropout=dropout)
        self.cvr_tower = self._mlp(self.in_dim, tower_units, output_dim=1,
                                   dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        x = self._embed_flat(batch)
        pctr = torch.sigmoid(self.ctr_tower(x))
        pcvr = torch.sigmoid(self.cvr_tower(x))
        return torch.cat([pctr, pctr * pcvr], dim=-1)


class AITM(_MTLBase):
    """Adaptive information transfer: task t's tower output attends over
    itself and a transfer (``transfer_<t>``) of task t − 1's, through
    bias-free ``q<t>`` / ``k<t>`` / ``v<t>``; a ``head_<t>`` a task."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 tower_units: Sequence[int] = (128, 64),
                 transfer_dim: int = 32, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, generator, device)
        g, dev, h = self._gen, self._dev, transfer_dim
        self.transfer_dim = h
        for t in range(self.num_tasks):
            self.add_module(f"tower_{t}", self._mlp(
                self.in_dim, tower_units, output_dim=h, dropout=dropout))
        for t in range(1, self.num_tasks):
            self.add_module(f"transfer_{t}", dense(h, h, g, dev))
            for name in ("q", "k", "v"):
                self.add_module(f"{name}{t}", dense(h, h, g, dev,
                                                    bias=False))
        for t in range(self.num_tasks):
            self.add_module(f"head_{t}", dense(h, 1, g, dev))

    def logits(self, batch) -> torch.Tensor:
        x = self._embed_flat(batch)
        outs, prev = [], None
        for t in range(self.num_tasks):
            cur = getattr(self, f"tower_{t}")(x)
            if prev is not None:
                stack = torch.stack(
                    [cur, getattr(self, f"transfer_{t}")(prev)], dim=1)
                q, k, v = (getattr(self, f"{n}{t}")(stack)
                           for n in ("q", "k", "v"))
                att = torch.softmax(torch.sum(q * k, dim=-1)
                                    / math.sqrt(float(self.transfer_dim)),
                                    dim=-1)
                cur = torch.einsum("bn,bnh->bh", att, v)
            outs.append(getattr(self, f"head_{t}")(cur))
            prev = cur
        return torch.cat(outs, dim=-1)
