"""The dense trainer: forward, loss, global-norm clip, Adam.

Counterpart of `recbox_tpu/training/trainer.py` `TrainerConfig` (:50-83),
`_make_optimizer` (:86-101) and the `Trainer` methods `init`, `train_step`,
`train_steps_repeat`, `predict`, `learning_rate` and `_set_learning_rate`.
PyTorch runs eagerly, so a step is the model's forward, ``backward`` through
`torch.autograd.grad`, and the optimizer, with nothing compiled. The phases
run inside `torch.profiler.record_function` ranges (``trainer::forward``,
``trainer::backward``, ``trainer::adam``, and the packed trainer's
``packed::gather`` and ``packed::row_update``), so a profile attributes
device time to them; without a profiler a range costs a few microseconds.

The optimizer is optax's ``chain(clip_by_global_norm(max_norm), adam(lr))``
written out with optax's formulas (`_Adam`): the clip scales every gradient
by max_norm / ||g|| when the global norm ||g|| reaches max_norm (not
`clip_grad_norm_`, whose +1e-6 differs), and Adam's update is
-lr · m̂ / (sqrt(v̂) + eps). Not ported yet, each raising
NotImplementedError that names its `ROADMAP.md` item: `fit` with its early
stop, plateau LR and best-weight reload, evaluation, checkpoints, the
optimizers other than Adam, `train_steps_fused` and the mesh.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.data.loader import MASK_KEY
from recbox_tpu_torch.ops.losses import embedding_reg_loss

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["Trainer", "TrainerConfig"]

_TRAINER_ITEM = ("is not ported yet (ROADMAP.md, Queue A: the training/"
                 "trainer.py remainder)")


@dataclasses.dataclass
class TrainerConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    grad_clip_norm: float = 10.0
    epochs: int = 10
    patience: int = 2
    monitor: Union[str, Mapping[str, float]] = "AUC"
    monitor_mode: str = "max"
    lr_decay_factor: float = 0.1
    min_lr: float = 1e-6
    reload_best_on_plateau: bool = True
    # (1/2)·||W||² over the tables, the JAX package's full-table penalty
    embedding_regularizer: float = 0.0
    net_regularizer: float = 0.0
    eval_steps: Optional[int] = None
    fused_steps: int = 1
    workdir: Optional[str] = None
    seed: int = 2024
    rng_impl: str = "rbg"
    log_every: int = 100


class _Adam:
    """optax ``chain(clip_by_global_norm(max_norm), adam(lr))`` over a list
    of tensors, in optax's formulas and op order."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 max_norm: Optional[float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr = float(lr)
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        if self.max_norm:
            g_norm = torch.sqrt(sum(torch.sum(torch.square(g))
                                    for g in grads))
            keep = g_norm < self.max_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_norm)
                     for g in grads]
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1.0 - self.b1) * g + self.b1 * m)
            v.copy_((1.0 - self.b2) * torch.square(g) + self.b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(u * -self.lr)


def _make_optimizer(cfg: TrainerConfig, params: List[torch.Tensor]) -> _Adam:
    if cfg.optimizer.lower() != "adam":
        raise NotImplementedError(
            f"optimizer={cfg.optimizer!r} {_TRAINER_ITEM}; 'adam' is ported")
    max_norm = cfg.grad_clip_norm if cfg.grad_clip_norm \
        and cfg.grad_clip_norm > 0 else None
    return _Adam(params, cfg.learning_rate, max_norm)


class Trainer:
    """Trainer over a torch model + a loss adapter.

    Args:
      model: a `torch.nn.Module`; ``model(batch)`` gives the outputs
        ``loss_fn`` reads.
      loss_fn: ``loss_fn(outputs, batch) -> scalar tensor``.
      config: TrainerConfig.
      eval_fn, mesh: as in the JAX package; ``mesh`` raises and
        ``train_method`` is not taken (not ported).
      device: where the model trains; the CUDA device unless named
        (`recbox_tpu_torch.resolve_device`). The model is moved there.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 config: TrainerConfig, eval_fn: Optional[Callable] = None,
                 mesh=None,
                 device: Optional[Union[str, torch.device]] = None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP.md, Queue A: "
                "parallel/)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.config = config
        self.eval_fn = eval_fn
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self._opt: Optional[_Adam] = None
        self.step = 0
        self.epoch = 0

    # -- init ----------------------------------------------------------------
    def init(self, sample_batch: Dict[str, np.ndarray]) -> None:
        """Set up the optimizer over the model's parameters (drawn when the
        model was built, from its generator)."""
        self.params = dict(self.model.named_parameters())
        self._opt = _make_optimizer(self.config, list(self.params.values()))
        n_params = sum(p.numel() for p in self.params.values())
        logger.info("initialized model: %s params", f"{n_params:,}")

    def _device_batch(self, batch: Mapping[str, Any]
                      ) -> Dict[str, torch.Tensor]:
        """The batch as tensors on the trainer's device (a tensor already
        there is used as it is)."""
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    # -- the train step ------------------------------------------------------
    def _dense_step(self, loss: torch.Tensor,
                    extra: List[torch.Tensor] = ()) -> List[torch.Tensor]:
        """Backward of ``loss`` to the dense parameters and ``extra``; an
        Adam step on the dense ones; the gradients of ``extra`` back."""
        params = list(self.params.values())
        with record_function("trainer::backward"):
            grads = torch.autograd.grad(loss, params + list(extra),
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(params + list(extra), grads)]
        with record_function("trainer::adam"):
            self._opt.step(grads[:len(params)])
        return grads[len(params):]

    def train_step(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """One step on ``batch``; returns the loss as a device scalar."""
        if self.params is None:
            self.init(batch)
        return self._train_step(self._device_batch(batch))

    def _train_step(self, dbatch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        self.model.train()
        with record_function("trainer::forward"):
            loss = self.loss_fn(self.model(dbatch), dbatch)
        if cfg.embedding_regularizer or cfg.net_regularizer:
            tables = {n: p for n, p in self.params.items()
                      if ".tables." in "." + n}
            if cfg.embedding_regularizer:
                loss = loss + cfg.embedding_regularizer * embedding_reg_loss(
                    tables, prefix="", device=self.device)
            if cfg.net_regularizer:
                net = {n: p for n, p in self.params.items()
                       if n not in tables}
                loss = loss + cfg.net_regularizer * embedding_reg_loss(
                    net, prefix="", device=self.device)
        self._dense_step(loss)
        self.step += 1
        return loss.detach()

    def train_steps_repeat(self, batch: Mapping[str, Any],
                           n_steps: int) -> torch.Tensor:
        """``n_steps`` steps on ONE device-resident batch: the compute
        probe of the step itself. Returns the (n_steps,) losses."""
        if self.params is None:
            self.init(batch)
        dbatch = self._device_batch(batch)
        return torch.stack([self._train_step(dbatch)
                            for _ in range(n_steps)])

    def train_steps_fused(self, batches):
        raise NotImplementedError(f"train_steps_fused {_TRAINER_ITEM}")

    def fit(self, train_loader, epochs: Optional[int] = None):
        raise NotImplementedError(
            f"fit (early stop, plateau LR, best reload, checkpoints) "
            f"{_TRAINER_ITEM}")

    def save(self, path: str) -> None:
        raise NotImplementedError(f"checkpoints {_TRAINER_ITEM}")

    def load(self, path: str) -> None:
        raise NotImplementedError(f"checkpoints {_TRAINER_ITEM}")

    # -- inference -----------------------------------------------------------
    def _forward_inputs(self, dbatch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return dbatch

    @torch.no_grad()
    def predict(self, loader, output_key: Optional[Callable] = None
                ) -> np.ndarray:
        """The model's eval-mode outputs over ``loader`` as one numpy array,
        tail-batch pads dropped by its mask."""
        if getattr(loader, "shuffle", False):
            raise ValueError(
                "predict() needs an order-preserving loader; construct it "
                "with shuffle=False")
        self.model.eval()
        outs = []
        for batch in loader:
            mask = batch.pop(MASK_KEY, None)
            dbatch = self._device_batch(batch)
            raw = self.model(self._forward_inputs(dbatch))
            if callable(output_key):
                raw = output_key(raw)
            elif output_key is not None:
                raw = raw[output_key]
            out = raw.float().cpu().numpy()
            if mask is not None:
                out = out[np.asarray(mask).astype(bool)] if mask.ndim == 1 \
                    else out
            outs.append(out)
        return np.concatenate(outs, axis=0)

    # -- learning rate -------------------------------------------------------
    @property
    def learning_rate(self) -> float:
        return self._opt.lr

    def _set_learning_rate(self, lr: float) -> None:
        self._opt.lr = float(lr)
