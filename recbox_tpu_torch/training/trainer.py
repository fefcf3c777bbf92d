"""The dense trainer: the step, its optimizers, `fit`, checkpoints.

Counterpart of `recbox_tpu/training/trainer.py`: `TrainerConfig` (:50-83),
`_make_optimizer` (:86-101) and the `Trainer` methods `init`, `train_step`,
`train_steps_fused`, `train_steps_repeat`, `fit` with early stop, plateau
LR and best-weight reload (:342-506), `apply`, `predict`, `state_dict`,
`save` and `load` (:568-605), with ``train_method=`` (the model method a
step drives, e.g. a sequential model's ``'full_scores'`` or
``'fused_ce_loss'``) and its guard against a mesh (:133-143). PyTorch runs
eagerly: a step is the model's forward, ``backward`` through
`torch.autograd.grad`, and the optimizer. The phases run inside
`torch.profiler.record_function` ranges (``trainer::forward``,
``trainer::backward``, ``trainer::adam`` (every optimizer), and the packed
trainer's ``packed::gather`` and ``packed::row_update``), so a profile
attributes device time to them; without a profiler a range costs a few
microseconds. On the card `train_steps_fused` replays one CUDA graph of the
step a batch (`training/graph.py`); on the CPU it is a loop of the same
steps.

The model's state beside its parameters (``model_state``: its persistent
buffers, the BatchNorm running statistics, flax's ``batch_stats``) moves
in the forward of a training step, in place, so a replayed graph moves it
too; it goes with the parameters through the best-weight cache,
`state_dict` / `load_state_dict`, `save` and `load`, as JAX's
``model_state`` does (`recbox_tpu/training/trainer.py:148`, :182, :214-225,
:353-362, :574).

Dropout draws from a generator the trainer owns: `init` makes it on the
trainer's device, seeded from ``TrainerConfig.seed``, and hands it to every
`nn.core.Dropout` of the model, so the same seed gives the same steps
whatever else uses torch's global generator. Its stream is Philox, not the
JAX package's rbg/threefry, so the two packages drop different elements.

The optimizers are optax's ``chain(clip_by_global_norm(max_norm),
<rule>(lr))`` written out with optax's formulas, not `torch.optim`'s: the
clip scales every gradient by max_norm / ||g|| when the global norm ||g||
reaches max_norm (not `clip_grad_norm_`, whose +1e-6 differs); adam and
adamw (decoupled decay ``weight_decay`` times lr, on every parameter),
adagrad (accumulators from 0.1, eps 1e-7 inside the root), sgd (no
momentum) and rmsprop (decay 0.9, eps 1e-8 inside the root, no centering).
Each steps all its tensors at once with `torch._foreach_*` ops in optax's
op order; its learning rate and step count are device tensors, so a
captured step reads the lr that plateau set and advances the count. The
mesh is not ported yet and raises NotImplementedError naming its
`ROADMAP.md` item.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.data.loader import MASK_KEY
from recbox_tpu_torch.nn.core import set_dropout_generator
from recbox_tpu_torch.ops.losses import embedding_reg_loss
from recbox_tpu_torch.training.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from recbox_tpu_torch.training.graph import StepGraph
from recbox_tpu_torch.training.monitor import Monitor

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["Trainer", "TrainerConfig", "is_embedding_table"]


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
    # K > 1: fit trains K batches a `train_steps_fused` call (one CUDA
    # graph replay a step on the card)
    fused_steps: int = 1
    workdir: Optional[str] = None
    seed: int = 2024
    rng_impl: str = "rbg"
    log_every: int = 100


# -- the optimizers ------------------------------------------------------------

class _Optimizer:
    """optax ``chain(clip_by_global_norm(max_norm), <rule>(lr))`` over a
    list of tensors. ``lr`` (optax's injected hyperparameter) and ``count``
    are 0-dim device tensors; ``slots`` name the per-tensor state lists and
    ``init`` their starting value."""

    slots: tuple = ()
    init = 0.0

    def __init__(self, params: List[torch.Tensor], lr: float,
                 max_norm: Optional[float]):
        self.params = list(params)
        dev = self.params[0].device if self.params else torch.device("cpu")
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.max_norm = max_norm
        self.state = {name: [torch.full_like(p, self.init)
                             for p in self.params] for name in self.slots}

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax's clip_by_global_norm: g where ||g|| < max_norm, else
        (g / ||g||) · max_norm. ||g|| is the norm of the per-tensor norms
        (optax sums every square in one sum)."""
        if not self.max_norm or not grads:
            return grads
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        keep = g_norm < self.max_norm
        scaled = torch._foreach_mul(torch._foreach_div(grads, g_norm),
                                    self.max_norm)
        return [torch.where(keep, g, s) for g, s in zip(grads, scaled)]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        grads = self._clip(list(grads))
        self.count.add_(1)
        if self.params:
            self._update(grads)

    def _update(self, grads: List[torch.Tensor]) -> None:
        raise NotImplementedError

    def _apply(self, updates: List[torch.Tensor]) -> None:
        """scale_by_learning_rate, then apply_updates: p + u · (-lr)."""
        torch._foreach_add_(self.params, torch._foreach_mul(updates,
                                                            -self.lr))

    def state_dict(self) -> Dict[str, Any]:
        return {"lr": self.lr, "count": self.count, **self.state}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a `state_dict` in place (a captured step reads these
        tensors)."""
        if set(state) != set(self.state_dict()):
            raise ValueError(f"optimizer state {sorted(state)} does not "
                             f"match {sorted(self.state_dict())}")
        _copy_into(self.lr, state["lr"], "lr")
        _copy_into(self.count, state["count"], "count")
        for name in self.slots:
            if len(state[name]) != len(self.state[name]):
                raise ValueError(f"optimizer state {name!r}: "
                                 f"{len(state[name])} tensors for "
                                 f"{len(self.state[name])}")
            for i, (dst, src) in enumerate(zip(self.state[name],
                                               state[name])):
                _copy_into(dst, src, f"{name}[{i}]")


class _AdamRule(_Optimizer):
    """optax.scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)."""

    slots = ("mu", "nu")
    b1, b2, eps = 0.9, 0.999, 1e-8

    def _adam_updates(self, grads):
        mu, nu = self.state["mu"], self.state["nu"]
        count = self.count.to(torch.float32)
        bc1 = 1.0 - torch.pow(self.b1, count)
        bc2 = 1.0 - torch.pow(self.b2, count)
        # (1 - b1) g + b1 mu, (1 - b2) g² + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        # (mu / bc1) / (sqrt(nu / bc2) + eps)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        return torch._foreach_div(torch._foreach_div(mu, bc1), den)


class _ForeachAdam(_AdamRule):
    def _update(self, grads):
        self._apply(self._adam_updates(grads))


class _Adam(_AdamRule):
    """The same Adam one tensor at a time: the reference the tests hold
    the multi-tensor one to, bit for bit on the CPU."""

    def _update(self, grads):
        count = self.count.to(torch.float32)
        bc1 = 1.0 - torch.pow(self.b1, count)
        bc2 = 1.0 - torch.pow(self.b2, count)
        for p, g, m, v in zip(self.params, grads, self.state["mu"],
                              self.state["nu"]):
            m.copy_(self.b1 * m + (1.0 - self.b1) * g)
            v.copy_(self.b2 * v + (1.0 - self.b2) * (g * g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(u * -self.lr)


class _AdamW(_AdamRule):
    """optax.adamw: Adam's update plus ``weight_decay`` · p, times -lr."""

    def __init__(self, params, lr, max_norm, weight_decay: float):
        super().__init__(params, lr, max_norm)
        self.weight_decay = float(weight_decay)

    def _update(self, grads):
        u = self._adam_updates(grads)
        torch._foreach_add_(u, torch._foreach_mul(self.params,
                                                  self.weight_decay))
        self._apply(u)


class _Adagrad(_Optimizer):
    """optax.adagrad: acc = g² + acc from 0.1; g · rsqrt(acc + 1e-7).
    optax gives 0 where acc == 0, which an accumulator that starts at 0.1
    and only grows never is."""

    slots = ("sum_of_squares",)
    init, eps = 0.1, 1e-7

    def _update(self, grads):
        acc = self.state["sum_of_squares"]
        torch._foreach_add_(acc, torch._foreach_mul(grads, grads))
        inv = torch._foreach_reciprocal(
            torch._foreach_sqrt(torch._foreach_add(acc, self.eps)))
        self._apply(torch._foreach_mul(inv, grads))


class _SGD(_Optimizer):
    """optax.sgd without momentum: -lr · g."""

    def _update(self, grads):
        self._apply(grads)


class _RMSProp(_Optimizer):
    """optax.rmsprop: nu = 0.1 g² + 0.9 nu from 0; g · rsqrt(nu + 1e-8)."""

    slots = ("nu",)
    decay, eps = 0.9, 1e-8

    def _update(self, grads):
        nu = self.state["nu"]
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - self.decay)
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_add_(nu, g2)
        inv = torch._foreach_reciprocal(
            torch._foreach_sqrt(torch._foreach_add(nu, self.eps)))
        self._apply(torch._foreach_mul(inv, grads))


def _copy_into(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    """``dst.copy_(src)``, refusing a shape or a dtype that differs (copy_
    would broadcast or cast)."""
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(f"{name}: {src.dtype} {tuple(src.shape)} does not "
                         f"fit {dst.dtype} {tuple(dst.shape)}")
    dst.copy_(src)


def _stack(values: List[Any]):
    """K per-step batch columns as one (K, ...) column: a tensor for
    tensors (batches already on the card), else a numpy array."""
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return np.stack(values)


def _make_optimizer(cfg: TrainerConfig,
                    params: List[torch.Tensor]) -> _Optimizer:
    max_norm = cfg.grad_clip_norm if cfg.grad_clip_norm \
        and cfg.grad_clip_norm > 0 else None
    name = cfg.optimizer.lower()
    if name == "adamw":
        return _AdamW(params, cfg.learning_rate, max_norm, cfg.weight_decay)
    rules = {"adam": _ForeachAdam, "adagrad": _Adagrad, "sgd": _SGD,
             "rmsprop": _RMSProp}
    if name not in rules:
        raise NotImplementedError(f"optimizer={cfg.optimizer}")
    return rules[name](params, cfg.learning_rate, max_norm)


def is_embedding_table(name: str) -> bool:
    """Whether the regularizers take the parameter ``name`` as an embedding
    table: as in the JAX package (`training/trainer.py:232-237`,
    `ops/losses.py:100-117`), when a component of its flax name starts with
    ``emb_``. The flax name of a `FeatureEmbedding` table
    ``<module>.tables.<t>`` is ``<module>/emb_<t>`` (`interop`'s mapping);
    a bare table such as SASRec's ``emb_item`` keeps its name."""
    parts = name.split(".")
    return any(p.startswith("emb_") or (i > 0 and parts[i - 1] == "tables")
               for i, p in enumerate(parts))


class Trainer:
    """Trainer over a torch model + a loss adapter + an evaluator.

    Args:
      model: a `torch.nn.Module`; ``model(batch)`` (or
        ``getattr(model, train_method)(batch)``) gives the outputs
        ``loss_fn`` reads.
      loss_fn: ``loss_fn(outputs, batch) -> scalar tensor``.
      config: TrainerConfig.
      eval_fn: ``eval_fn(trainer) -> {metric: value}`` on the validation
        set (e.g. `CTREvaluator`, `RetrievalEvaluator`).
      mesh: as in the JAX package; a ``mesh`` raises (not ported).
      train_method: name of the model method a step drives; None =
        ``model(batch)``. ``'full_scores'`` (with `full_softmax_loss`) and
        ``'fused_ce_loss'`` (with an identity loss) are the full-softmax
        CE protocols of the sequential models.
      device: where the model trains; the CUDA device unless named
        (`recbox_tpu_torch.resolve_device`). The model is moved there.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 config: TrainerConfig, eval_fn: Optional[Callable] = None,
                 mesh=None,
                 device: Optional[Union[str, torch.device]] = None,
                 train_method: Optional[str] = None):
        if mesh is not None and train_method == "fused_ce_loss":
            # the flash-CE kernel is a single-shard op, as in the JAX
            # package (`recbox_tpu/training/trainer.py:133-143`)
            raise ValueError(
                "train_method='fused_ce_loss' is a single-shard path and "
                "cannot run under a mesh; use train_method='full_scores' "
                "+ full_softmax_loss")
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP.md, Queue A: "
                "parallel/)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.config = config
        self.eval_fn = eval_fn
        self.train_method = train_method
        # the step's forward; predict calls the model itself, as in JAX
        self._step_forward = self.model if train_method is None \
            else getattr(self.model, train_method)
        self.monitor = Monitor(config.monitor, config.monitor_mode,
                               patience=config.patience)
        self.dropout_generator: Optional[torch.Generator] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.model_state: Dict[str, torch.Tensor] = {}
        self._opt: Optional[_Optimizer] = None
        self.step = 0
        self.epoch = 0
        self._best: Optional[Dict[str, torch.Tensor]] = None
        self._best_model_state: Dict[str, torch.Tensor] = {}
        self._stopped = False
        # optional external stop poll, checked between steps in fit();
        # returning True ends the loop
        self.stop_callback: Optional[Callable[[], bool]] = None
        self._graph: Optional[StepGraph] = None
        self._graph_warm = 0

    # -- init ----------------------------------------------------------------
    def init(self, sample_batch: Dict[str, np.ndarray]) -> None:
        """Set up the optimizer over the model's parameters (drawn when the
        model was built, from its generator) and hand the model's dropouts
        a generator seeded from ``config.seed``."""
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(self.config.seed)
        set_dropout_generator(self.model, self.dropout_generator)
        self.params = dict(self.model.named_parameters())
        self.model_state = {
            n: t for n, t in self.model.state_dict(keep_vars=True).items()
            if not isinstance(t, torch.nn.Parameter)}
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
        optimizer step on the dense ones; the gradients of ``extra`` back."""
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
        loss = self._train_step(self._device_batch(batch))
        self.step += 1
        return loss

    def _train_step(self, dbatch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The step's device work (captured as a graph on the card): no
        host counter moves here."""
        cfg = self.config
        self.model.train()
        with record_function("trainer::forward"):
            loss = self.loss_fn(self._step_forward(dbatch), dbatch)
        if cfg.embedding_regularizer or cfg.net_regularizer:
            tables = {n: p for n, p in self.params.items()
                      if is_embedding_table(n)}
            if cfg.embedding_regularizer:
                loss = loss + cfg.embedding_regularizer * embedding_reg_loss(
                    tables, prefix="", device=self.device)
            if cfg.net_regularizer:
                net = {n: p for n, p in self.params.items()
                       if n not in tables}
                loss = loss + cfg.net_regularizer * embedding_reg_loss(
                    net, prefix="", device=self.device)
        self._dense_step(loss)
        return loss.detach()

    def train_steps_fused(self, batches: Mapping[str, Any]) -> torch.Tensor:
        """K train steps over ``batches`` ((K, B, ...) arrays or tensors, K
        per-step batches stacked on a leading axis); the (K,) losses.

        On the card the step runs as one CUDA graph replayed K times over
        the staged batches (`training/graph.py`), with the results of K
        `train_step` calls; a failed capture or replay raises. On the CPU
        the K steps run one after another."""
        first = {k: v[0] for k, v in batches.items()}
        if self.params is None:
            self.init(first)
        k = len(next(iter(batches.values())))
        if self.device.type != "cuda":
            losses = torch.stack([
                self._train_step(self._device_batch(
                    {n: v[i] for n, v in batches.items()}))
                for i in range(k)])
        else:
            if self._graph is None or not self._graph.fits(batches, k):
                self._graph = StepGraph(self, batches, k)
            losses = self._graph.run(batches, k)
        self.step += k
        return losses

    def _graph_token(self):
        """What a captured step holds by value and must be captured again
        for when it changes: nothing for the dense trainer (its lr is a
        device tensor)."""
        return None

    def train_steps_repeat(self, batch: Mapping[str, Any],
                           n_steps: int) -> torch.Tensor:
        """``n_steps`` steps on ONE device-resident batch: the compute
        probe of the step itself. Returns the (n_steps,) losses."""
        if self.params is None:
            self.init(batch)
        dbatch = self._device_batch(batch)
        losses = torch.stack([self._train_step(dbatch)
                              for _ in range(n_steps)])
        self.step += n_steps
        return losses

    # -- lr plateau ----------------------------------------------------------
    @property
    def learning_rate(self) -> float:
        return float(self._opt.lr)

    def _set_learning_rate(self, lr: float) -> None:
        self._opt.lr.fill_(float(lr))

    def _capture_best(self) -> None:
        """A copy of the parameters and the model state on their device (a
        clone: the steps update both in place)."""
        self._best = {n: p.detach().clone() for n, p in self.params.items()}
        self._best_model_state = {n: t.detach().clone()
                                  for n, t in self.model_state.items()}

    @torch.no_grad()
    def _restore_best(self) -> None:
        if self._best is None:
            return
        for n, p in self.params.items():
            p.copy_(self._best[n])
        for n, t in self.model_state.items():
            t.copy_(self._best_model_state[n])

    def _on_plateau(self) -> None:
        new_lr = max(self.learning_rate * self.config.lr_decay_factor,
                     self.config.min_lr)
        logger.info("plateau: reducing lr %.3g -> %.3g", self.learning_rate,
                    new_lr)
        if self.config.reload_best_on_plateau:
            self._restore_best()
        self._set_learning_rate(new_lr)

    # -- fit loop ------------------------------------------------------------
    def fit(self, train_loader, epochs: Optional[int] = None,
            valid_loader=None) -> Dict[str, float]:
        """Train for ``epochs`` (default ``config.epochs``) from
        ``self.epoch``, evaluating with ``eval_fn`` each epoch (or each
        ``eval_steps`` steps): best-weight capture, plateau LR with best
        reload, early stop after ``patience`` plateaus, the best weights
        restored at the end. Returns the last evaluation's metrics."""
        if valid_loader is not None:
            # evaluation is driven by eval_fn, not a raw loader: fail loudly
            # instead of silently skipping validation
            raise TypeError(
                "fit() does not consume a raw valid_loader; pass an "
                "evaluator as eval_fn= at construction (e.g. "
                "CTREvaluator/RetrievalEvaluator)")
        epochs = epochs or self.config.epochs
        self._stopped = False   # a prior early-stopped fit() must not leak
        if self.params is None:
            peek = getattr(train_loader, "peek_batch", None)
            sample = peek() if peek is not None else next(iter(train_loader))
            self.init(sample)
        # the loader's tail batch is dropped for training, padded and
        # masked for evaluation; fit drops the mask and trains on every
        # row, so a padding loader would train on repeats of one example
        n = getattr(train_loader, "num_samples", None)
        bs = getattr(train_loader, "batch_size", None)
        if getattr(train_loader, "drop_last", None) is False \
                and n and bs and n % bs:
            if n >= bs:
                raise ValueError(
                    f"training loader pads its tail batch ({n % bs} real "
                    f"rows repeated up to {bs}) and Trainer.fit trains on "
                    "the padding — construct the train loader with "
                    "drop_last=True (the tail is dropped), or align "
                    "batch_size to the dataset size")
            logger.warning(
                "dataset smaller than one batch (%d < %d): training on a "
                "padded batch (last row repeated %d times); prefer "
                "batch_size=%d", n, bs, bs - n, n)
        last_metrics: Dict[str, float] = {}
        K = max(1, self.config.fused_steps)
        eval_steps = self.config.eval_steps
        # eval fires whenever the step counter CROSSES a multiple of
        # eval_steps (fused steps advance it by K)
        eval_marker = self.step // eval_steps if eval_steps else 0
        for epoch in range(self.epoch, epochs):
            self.epoch = epoch
            t0 = time.time()
            losses: List[torch.Tensor] = []
            pending = []
            for batch in train_loader:
                if self.stop_callback is not None and self.stop_callback():
                    logger.warning("external stop at epoch %d step %d",
                                   epoch, self.step)
                    return last_metrics
                batch.pop(MASK_KEY, None)
                if K > 1:
                    pending.append(batch)
                    if len(pending) < K:
                        continue
                    stacked = {k: _stack([b[k] for b in pending])
                               for k in pending[0]}
                    pending = []
                    losses.append(self.train_steps_fused(stacked))
                else:
                    losses.append(self.train_step(batch).reshape(1))
                if eval_steps and self.step // eval_steps > eval_marker:
                    eval_marker = self.step // eval_steps
                    last_metrics = self._evaluate_and_checkpoint()
                    if self._stopped:
                        break
            # flush a short tail one step at a time
            for batch in pending:
                if self._stopped:
                    break
                losses.append(self.train_step(batch).reshape(1))
                if eval_steps and self.step // eval_steps > eval_marker:
                    eval_marker = self.step // eval_steps
                    last_metrics = self._evaluate_and_checkpoint()
            mean_loss = float(torch.cat(losses).float().mean()) if losses \
                else float("nan")
            if np.isnan(mean_loss):
                raise ValueError(f"nan loss at epoch {epoch}")
            logger.info("epoch %d: loss %.6f (%.1fs, %d steps)", epoch,
                        mean_loss, time.time() - t0,
                        sum(len(x) for x in losses))
            if not eval_steps:
                last_metrics = self._evaluate_and_checkpoint()
            # a completed epoch advances the counter, so a checkpoint saved
            # now resumes at the next epoch
            self.epoch = epoch + 1
            if self._stopped:
                logger.info("early stop at epoch %d (best epoch %d)",
                            epoch, self.monitor.best_epoch)
                break
        self._restore_best()
        return last_metrics

    def _evaluate_and_checkpoint(self) -> Dict[str, float]:
        if self.eval_fn is None:
            return {}
        metrics = self.eval_fn(self)
        value, improved, should_stop = self.monitor.update(metrics,
                                                           self.epoch)
        logger.info("eval @ epoch %d step %d: %s -> monitor %.6f%s",
                    self.epoch, self.step,
                    " ".join(f"{k}={v:.6f}" for k, v in metrics.items()),
                    value, " *best*" if improved else "")
        if improved:
            self._capture_best()
            if self.config.workdir:
                self.save(f"{self.config.workdir}/best.ckpt")
        elif not should_stop:
            self._on_plateau()
        self._stopped = should_stop
        return metrics

    # -- inference -----------------------------------------------------------
    def _forward_inputs(self, dbatch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return dbatch

    @torch.no_grad()
    def apply(self, batch: Mapping[str, Any],
              method: Optional[Union[str, Callable]] = None,
              train: bool = False) -> Any:
        """The model (or ``method``: a name or a bound method of the
        model) on ``batch``, in eval mode unless ``train``; no gradients."""
        if method is not None and train:
            # method signatures differ: silently dropping the flag would
            # run eval-mode behaviour the caller did not ask for
            raise NotImplementedError(
                "apply(method=..., train=True) is unsupported: call the "
                "model's method in training mode directly")
        fn = self.model if method is None else (
            getattr(self.model, method) if isinstance(method, str)
            else method)
        self.model.train(train)
        return fn(self._forward_inputs(self._device_batch(batch)))

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

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The full training state: parameters, the model state, optimizer
        state (its lr and step count included), step, epoch and the
        monitor."""
        return {"params": dict(self.params),
                "model_state": dict(self.model_state),
                "opt_state": self._opt.state_dict(),
                "step": self.step, "epoch": self.epoch,
                "monitor": self.monitor.state()}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy ``state`` into the trainer in place (a captured step reads
        these tensors); shapes must match the trainer's, which `init`
        made."""
        if set(state["params"]) != set(self.params):
            raise ValueError(f"checkpoint params "
                             f"{sorted(set(state['params']) ^ set(self.params))}"
                             " do not match the model's")
        for n, p in self.params.items():
            _copy_into(p, state["params"][n], n)
        # a checkpoint written before the trainer carried model state has
        # none: it loads into a model without buffers, else the names differ
        model_state = state.get("model_state", {})
        if set(model_state) != set(self.model_state):
            raise ValueError(f"checkpoint model state "
                             f"{sorted(model_state)} does not match "
                             f"the model's {sorted(self.model_state)}")
        for n, t in self.model_state.items():
            _copy_into(t, model_state[n], n)
        self._opt.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
        self.monitor.restore(state["monitor"])
        # the saved state is the best so far (best.ckpt is written on
        # improvement): seed the best-weights cache from it, or a resumed
        # fit that never improves would end on drifted weights
        self._capture_best()

    def save(self, path: str) -> None:
        save_checkpoint(path, self.state_dict())

    def load(self, path: str) -> None:
        if self.params is None:
            raise RuntimeError("call init()/fit() before load() so shapes "
                               "exist")
        self.load_state_dict(load_checkpoint(path, map_location=self.device))
