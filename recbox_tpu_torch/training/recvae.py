"""RecVAE's alternating trainer: encoder and decoder phases and the
composite prior's refresh.

Counterpart of `recbox_tpu/training/recvae.py` `RecVAETrainer`: each epoch
runs ``n_enc_epochs`` sweeps that update only the encoder, refreshes the
frozen copy of the encoder the composite prior reads (``update_prior``),
then ``n_dec_epochs`` sweeps that update only the decoder (``dec``). Each
phase has its own Adam (optax's, without clipping) over its own
parameters, as JAX's ``masked(set_to_zero) + masked(adam)`` pair: the
other phase's parameters get no update and their moments do not move. A
sweep's batch order is ``default_rng(seed).permutation``, JAX's draw for
draw; the dropout and reparam draws come from two generators seeded from
``seed`` (Philox, not JAX's streams).
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.models.matching.autoencoder import recvae_loss
from recbox_tpu_torch.nn.core import (
    set_dropout_generator, set_reparam_generator,
)
from recbox_tpu_torch.training.trainer import (
    REPARAM_SEED_OFFSET, _ForeachAdam,
)

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["RecVAETrainer"]


class RecVAETrainer:
    """Alternating optimisation of a `RecVAE`::

        t = RecVAETrainer(model)
        t.fit(history, epochs=50, batch_size=500)
        scores = t.scores(history)     # (B, N) for retrieval evaluation
    """

    def __init__(self, model, learning_rate: float = 5e-4,
                 n_enc_epochs: int = 3, n_dec_epochs: int = 1,
                 seed: int = 2024,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.learning_rate = learning_rate
        self.n_enc_epochs, self.n_dec_epochs = n_enc_epochs, n_dec_epochs
        self.seed = seed
        self.old_model = None       # the composite prior's frozen encoder
        self._np_rng = np.random.default_rng(seed)
        self._opts: Dict[bool, _ForeachAdam] = {}
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        self.reparam_generator = torch.Generator(
            device=self.device).manual_seed(seed + REPARAM_SEED_OFFSET)
        set_dropout_generator(self.model, self.dropout_generator)
        set_reparam_generator(self.model, self.reparam_generator)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _init(self) -> None:
        self.update_prior()
        for decoder in (False, True):
            # the top-level module 'dec' is the decoder
            params = [p for n, p in self.model.named_parameters()
                      if (n.split(".")[0] == "dec") == decoder]
            self._opts[decoder] = _ForeachAdam(params, self.learning_rate,
                                               max_norm=None)

    def _step(self, batch: Dict[str, torch.Tensor], decoder: bool
              ) -> torch.Tensor:
        model, opt = self.model, self._opts[decoder]
        model.train()
        logits, mu, logvar, z = model.forward_with_latents(batch)
        # the prior's parameters are frozen; its gradient reaches z
        prior = self.old_model.composite_prior_logpdf(batch, z)
        loss = recvae_loss(logits, mu, logvar, z, prior, batch,
                           gamma=model.gamma, beta=model.beta)
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
        opt.step([torch.zeros_like(p) if g is None else g
                  for p, g in zip(opt.params, grads)])
        return loss.detach()

    def _sweep(self, history: np.ndarray, batch_size: int,
               decoder: bool) -> float:
        n = len(history)
        batch_size = min(batch_size, n)
        order = self._np_rng.permutation(n)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            rows = torch.from_numpy(history[order[i:i + batch_size]])
            losses.append(self._step({"history": rows.to(self.device)},
                                     decoder))
        return float(torch.stack(losses).mean()) if losses else float("nan")

    def update_prior(self) -> None:
        """old encoder ← the current one (a frozen copy in eval mode)."""
        if self.old_model is None:
            self.old_model = copy.deepcopy(self.model).eval()
            for p in self.old_model.parameters():
                p.requires_grad_(False)
        else:
            with torch.no_grad():
                for dst, src in zip(self.old_model.parameters(),
                                    self.model.parameters()):
                    dst.copy_(src)

    def fit(self, history: np.ndarray, epochs: int = 10,
            batch_size: int = 500,
            eval_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        history = np.asarray(history, np.float32)
        if not self._opts:
            self._init()
        for epoch in range(epochs):
            enc_loss = dec_loss = float("nan")
            for _ in range(self.n_enc_epochs):
                enc_loss = self._sweep(history, batch_size, decoder=False)
            self.update_prior()
            for _ in range(self.n_dec_epochs):
                dec_loss = self._sweep(history, batch_size, decoder=True)
            logger.info("recvae epoch %d: enc %.4f dec %.4f", epoch,
                        enc_loss, dec_loss)
            if eval_fn is not None:
                eval_fn(self)
        return self.params

    @torch.no_grad()
    def scores(self, history: np.ndarray) -> np.ndarray:
        """(B, N) scores of every item, for retrieval evaluation."""
        self.model.eval()
        x = torch.from_numpy(np.asarray(history, np.float32)).to(self.device)
        return self.model({"history": x}).float().cpu().numpy()
