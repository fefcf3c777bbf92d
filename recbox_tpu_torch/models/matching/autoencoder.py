"""Autoencoder recommenders: MultiVAE, MacridVAE, RecVAE, CDAE, RaCT.

Counterpart of `recbox_tpu/models/matching/autoencoder.py`. The models read
a user's whole interaction row (the multi-hot ``history`` (B, N) of
`build_history_matrix`) and give (B, N) logits over every item; they are
trained by reconstruction (multinomial CE + β·KL for the VAEs, pointwise
logistic for CDAE), with no sampled negatives and no towers.

The noise of flax's ``'reparam'`` stream (the VAEs' ε, CDAE's corruption)
comes from the module ``reparam`` (`nn.core.Reparam`), whose generator the
trainer hands out; the input dropout of MultiVAE / MacridVAE / RecVAE
draws from the dropout generator, as in JAX. In eval mode nothing is
drawn (z = μ). JAX sows the per-user KL into ``intermediates``; the port
returns it: ``forward_with_kl`` gives (logits, kl), RecVAE's
``forward_with_latents`` (logits, μ, logvar, z). The dense multinomial
log-likelihood is `log_softmax` over the logits, as in JAX (kernel B2 is
not on this path). Layer names are flax's (``enc<i>``, ``mu``, ``logvar``,
``dec<i>``, ``out``, RecVAE's ``enc_in`` / ``enc_norm0`` /
``enc_norms_<i>``, LayerNorms with flax's E[x²] − E[x]² variance; CDAE's
``user_bias.embedding``), so `interop.from_jax_params` maps a JAX param
tree onto them. RaCT's critic
(``critic<k>``, ``critic_out``) is made with the model; flax makes it on
the first `critic_score` call.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.models.base import _l2_normalize, init_rng
from recbox_tpu_torch.nn.attention import LayerNorm, dense
from recbox_tpu_torch.nn.core import (
    _TRUNC_STD, Dropout, Reparam, normal_table,
)

__all__ = ["MultiVAE", "MacridVAE", "RecVAE", "CDAE", "RaCT",
           "multivae_loss", "cdae_loss", "recvae_loss", "log_norm_pdf",
           "ract_critic_features", "build_history_matrix"]

Device = Optional[Union[str, torch.device]]


def build_history_matrix(user_ids, item_ids, num_users: int,
                         num_items: int) -> np.ndarray:
    """Dense multi-hot (num_users, num_items) float32 interaction rows."""
    x = np.zeros((num_users, num_items), dtype=np.float32)
    x[np.asarray(user_ids), np.asarray(item_ids)] = 1.0
    return x


def _sample_z(reparam: Reparam, mu: torch.Tensor, logvar: torch.Tensor,
              training: bool) -> torch.Tensor:
    if not training:
        return mu
    return mu + reparam.normal(mu.shape, mu.device) * torch.exp(0.5 * logvar)


def _gaussian_kl(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-user KL(N(μ, σ²) ‖ N(0, I)), (B,)."""
    return -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=1)


class _AutoEncoder(nn.Module):
    """`full_scores` is the forward (the (B, N) logits), as in JAX."""

    init_rng = staticmethod(init_rng)

    def full_scores(self, batch) -> torch.Tensor:
        return self(batch)


class MultiVAE(_AutoEncoder):
    """Variational AE with a multinomial likelihood: encoder MLP → (μ,
    logσ²) → z → decoder MLP → logits."""

    def __init__(self, num_items: int, hidden_units: Sequence[int] = (600,),
                 latent_dim: int = 128, dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__()
        g, dev = self.init_rng(generator, device)
        self.num_items, self.latent_dim = num_items, latent_dim
        self.hidden_units = tuple(hidden_units)
        self.drop = Dropout(dropout)
        self.reparam = Reparam()
        d_in = num_items
        for i, hu in enumerate(self.hidden_units):
            setattr(self, f"enc{i}", dense(d_in, hu, g, dev))
            d_in = hu
        self.mu = dense(d_in, latent_dim, g, dev)
        self.logvar = dense(d_in, latent_dim, g, dev)
        d_in = latent_dim
        for i, hu in enumerate(reversed(self.hidden_units)):
            setattr(self, f"dec{i}", dense(d_in, hu, g, dev))
            d_in = hu
        self.out = dense(d_in, num_items, g, dev)

    def forward_with_kl(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, N), per-user KL (B,))."""
        x = self.drop(_l2_normalize(batch["history"]))
        for i in range(len(self.hidden_units)):
            x = torch.tanh(getattr(self, f"enc{i}")(x))
        mu, logvar = self.mu(x), self.logvar(x)
        h = _sample_z(self.reparam, mu, logvar, self.training)
        for i in range(len(self.hidden_units)):
            h = torch.tanh(getattr(self, f"dec{i}")(h))
        return self.out(h), _gaussian_kl(mu, logvar)

    def forward(self, batch) -> torch.Tensor:
        return self.forward_with_kl(batch)[0]

    def elbo_loss(self, batch, beta: float = 0.2) -> torch.Tensor:
        """The training loss as a method, for ``Trainer(model, lambda out,
        b: out, train_method='elbo_loss')``."""
        logits, kl = self.forward_with_kl(batch)
        return multivae_loss(logits, batch, kl, beta=beta)


def multivae_loss(logits: torch.Tensor, batch, kl: torch.Tensor,
                  beta: float = 0.2) -> torch.Tensor:
    """Multinomial CE + β · mean KL (``kl`` per user or already a mean)."""
    ce = -torch.mean(torch.sum(F.log_softmax(logits, dim=-1)
                               * batch["history"], dim=-1))
    return ce + beta * torch.mean(kl)


class MacridVAE(_AutoEncoder):
    """Macro-micro disentangled VAE: K concept prototypes softly assign the
    items; one encoder per concept gives z_k; the scores are
    log Σ_k assign_ik · softmax_i(⟨z_k, e_i⟩ / τ) in cosine space."""

    def __init__(self, num_items: int, latent_dim: int = 64,
                 k_factors: int = 4, tau: float = 0.1, dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__()
        g, dev = self.init_rng(generator, device)
        self.num_items, self.latent_dim = num_items, latent_dim
        self.k_factors, self.tau = k_factors, float(tau)
        self.emb_item = normal_table((num_items, latent_dim), 0.05, g, dev)
        self.emb_proto = normal_table((k_factors, latent_dim), 0.05, g, dev)
        self.drop = Dropout(dropout)
        self.reparam = Reparam()
        self.enc_mu = dense(2 * latent_dim, latent_dim, g, dev)
        self.enc_lv = dense(2 * latent_dim, latent_dim, g, dev)
        for k in range(k_factors):
            setattr(self, f"enc{k}", dense(num_items, 2 * latent_dim, g, dev))

    def forward_with_kl(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(log-probabilities (B, N), per-user KL (B,)): the KL is
        −½ Σ(1 + logvar − e^logvar) summed over the factors, with no μ²
        term (μ lies on the unit sphere), as the reference's."""
        items_n = _l2_normalize(self.emb_item)
        cates = torch.softmax(items_n @ _l2_normalize(self.emb_proto).T
                              / self.tau, dim=-1)                  # (N, K)
        xd = self.drop(_l2_normalize(batch["history"]))
        probs, kl = 0.0, 0.0
        for k in range(self.k_factors):
            h = torch.tanh(getattr(self, f"enc{k}")(xd * cates[None, :, k]))
            mu = _l2_normalize(self.enc_mu(h))
            lv = self.enc_lv(h)
            z = _l2_normalize(_sample_z(self.reparam, mu, lv, self.training))
            probs = probs + torch.softmax(z @ items_n.T / self.tau, dim=-1) \
                * cates[None, :, k]
            kl = kl + -0.5 * torch.sum(1 + lv - torch.exp(lv), dim=1)
        return torch.log(probs + 1e-12), kl

    def forward(self, batch) -> torch.Tensor:
        return self.forward_with_kl(batch)[0]


def log_norm_pdf(x: torch.Tensor, mu, logvar) -> torch.Tensor:
    """Element-wise log N(x; μ, exp(logvar))."""
    mu = torch.as_tensor(mu, dtype=x.dtype, device=x.device)
    logvar = torch.as_tensor(logvar, dtype=x.dtype, device=x.device)
    return -0.5 * (logvar + math.log(2 * math.pi)
                   + torch.square(x - mu) / torch.exp(logvar))


class RecVAE(_AutoEncoder):
    """RecVAE: a denoising encoder of swish layers with LayerNorm, a linear
    decoder, and the composite prior (a mixture of N(0, I), the old
    encoder's posterior and N(0, e^10 I), weights ``mixture_weights``).
    The old encoder is a frozen copy of the model that `RecVAETrainer`
    refreshes (``update_prior``); `composite_prior_logpdf` runs on it."""

    def __init__(self, num_items: int, hidden_dim: int = 600,
                 latent_dim: int = 200, n_enc_layers: int = 3,
                 dropout: float = 0.5, gamma: float = 0.005,
                 beta: float = 0.2,
                 mixture_weights: Tuple[float, float, float] = (
                     3 / 20, 3 / 4, 1 / 10),
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__()
        g, dev = self.init_rng(generator, device)
        self.num_items, self.latent_dim = num_items, latent_dim
        self.n_enc_layers = n_enc_layers
        self.gamma, self.beta = float(gamma), float(beta)
        self.mixture_weights = tuple(mixture_weights)
        self.drop = Dropout(dropout)
        self.reparam = Reparam()
        self.enc_in = dense(num_items, hidden_dim, g, dev)
        self.enc_norm0 = LayerNorm(hidden_dim, device=dev,
                                   fast_variance=True)
        for i in range(n_enc_layers - 1):
            setattr(self, f"enc{i}", dense(hidden_dim, hidden_dim, g, dev))
            setattr(self, f"enc_norms_{i}",
                    LayerNorm(hidden_dim, device=dev, fast_variance=True))
        self.mu = dense(hidden_dim, latent_dim, g, dev)
        self.logvar = dense(hidden_dim, latent_dim, g, dev)
        self.dec = dense(latent_dim, num_items, g, dev)

    def encode(self, batch, noisy: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(μ, logvar) of q(z|x); the input dropout applies in training
        when ``noisy`` (the composite prior encodes without it)."""
        x = _l2_normalize(batch["history"])
        if noisy:
            x = self.drop(x)
        h = self.enc_norm0(F.silu(self.enc_in(x)))
        for i in range(self.n_enc_layers - 1):
            h = getattr(self, f"enc_norms_{i}")(
                F.silu(getattr(self, f"enc{i}")(h)) + h)
        return self.mu(h), self.logvar(h)

    def forward_with_latents(self, batch):
        """(logits, μ, logvar, z): what `recvae_loss` reads."""
        mu, logvar = self.encode(batch)
        z = _sample_z(self.reparam, mu, logvar, self.training)
        return self.dec(z), mu, logvar, z

    def forward(self, batch) -> torch.Tensor:
        return self.forward_with_latents(batch)[0]

    def composite_prior_logpdf(self, batch, z: torch.Tensor) -> torch.Tensor:
        """log p(z) under the three-component mixture, with this module's
        encoder (the frozen copy's, in `RecVAETrainer`)."""
        post_mu, post_logvar = self.encode(batch, noisy=False)
        w1, w2, w3 = self.mixture_weights
        comps = torch.stack([
            log_norm_pdf(z, 0.0, 0.0) + math.log(w1),
            log_norm_pdf(z, post_mu, post_logvar) + math.log(w2),
            log_norm_pdf(z, 0.0, 10.0) + math.log(w3)])
        return torch.logsumexp(comps, dim=0)


def recvae_loss(logits: torch.Tensor, mu: torch.Tensor,
                logvar: torch.Tensor, z: torch.Tensor,
                prior_logpdf: torch.Tensor, batch, gamma: float = 0.005,
                beta: float = 0.2) -> torch.Tensor:
    """The negative ELBO with the composite prior: the KL weight is
    gamma · |history| per user (beta when gamma is 0)."""
    x = batch["history"]
    mll = torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * x, dim=-1))
    kl_weight = gamma * torch.sum(x, dim=-1) if gamma else beta
    kld = torch.mean(kl_weight * torch.sum(
        log_norm_pdf(z, mu, logvar) - prior_logpdf, dim=-1))
    return -(mll - kld)


class _Embed(nn.Module):
    """flax ``nn.Embed``: the table ``embedding``, drawn as flax's default
    (truncated normal at variance 1 / width)."""

    def __init__(self, rows: int, dim: int, generator, device):
        super().__init__()
        std = math.sqrt(1.0 / dim) / _TRUNC_STD
        self.embedding = nn.Parameter(torch.empty(rows, dim, device=device))
        with torch.no_grad():
            nn.init.trunc_normal_(self.embedding, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class CDAE(_AutoEncoder):
    """Collaborative denoising AE: h = act(W x̃ + V_u + b), out = W' h + b',
    a per-user vector in the bottleneck; x̃ is the corrupted history (a
    'reparam' draw, as in JAX)."""

    def __init__(self, num_users: int, num_items: int, hidden_dim: int = 64,
                 corruption: float = 0.5, hidden_activation: str = "relu",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__()
        g, dev = self.init_rng(generator, device)
        self.num_users, self.num_items = num_users, num_items
        self.corruption = float(corruption)
        self.hidden_activation = hidden_activation
        self.reparam = Reparam()
        self.enc = dense(num_items, hidden_dim, g, dev)
        self.user_bias = _Embed(num_users, hidden_dim, g, dev)
        self.dec = dense(hidden_dim, num_items, g, dev)

    def forward(self, batch) -> torch.Tensor:
        x = batch["history"]
        if self.training:
            keep = self.reparam.keep(1.0 - self.corruption, x.shape, x.device)
            x = x * keep.to(x.dtype) / (1.0 - self.corruption)
        h = self.enc(x) + self.user_bias(batch["user_id"])
        h = torch.relu(h) if self.hidden_activation == "relu" \
            else torch.tanh(h)
        return self.dec(h)


def cdae_loss(logits: torch.Tensor, batch) -> torch.Tensor:
    """Pointwise logistic reconstruction over every item."""
    y = batch["history"]
    return torch.mean(torch.sum(
        torch.clamp(logits, min=0) - logits * y
        + torch.log1p(torch.exp(-torch.abs(logits))), dim=-1))


class RaCT(_AutoEncoder):
    """RaCT: a MultiVAE actor (``actor``) and a critic MLP that predicts
    the ranking quality from per-user [CE, KL, log1p(count)]
    (`ract_critic_features`). The phases (pretrain the actor on
    `multivae_loss`, fit the critic, fine-tune the actor against it) are
    the caller's loop, as in JAX."""

    def __init__(self, num_items: int, hidden_units: Sequence[int] = (600,),
                 latent_dim: int = 128, dropout: float = 0.5,
                 critic_hidden: Sequence[int] = (64, 32),
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__()
        g, dev = self.init_rng(generator, device)
        self.num_items = num_items
        self.actor = MultiVAE(num_items, hidden_units, latent_dim, dropout,
                              generator=g, device=dev)
        self.critic_hidden = tuple(critic_hidden)
        d_in = 3
        for k, w in enumerate(self.critic_hidden):
            setattr(self, f"critic{k}", dense(d_in, w, g, dev))
            d_in = w
        self.critic_out = dense(d_in, 1, g, dev)

    def forward(self, batch) -> torch.Tensor:
        return self.actor(batch)

    def critic_score(self, feats: torch.Tensor) -> torch.Tensor:
        """feats (B, 3) → the predicted NDCG (B,)."""
        h = feats
        for k in range(len(self.critic_hidden)):
            h = torch.relu(getattr(self, f"critic{k}")(h))
        return torch.sigmoid(self.critic_out(h))[..., 0]


def ract_critic_features(logits: torch.Tensor, batch,
                         kl: torch.Tensor) -> torch.Tensor:
    """Per-user [CE, KL, log1p(count)], (B, 3)."""
    ce = -torch.sum(F.log_softmax(logits, dim=-1) * batch["history"], dim=-1)
    counts = torch.sum(batch["history"], dim=-1)
    return torch.stack([ce, torch.broadcast_to(kl, ce.shape),
                        torch.log1p(counts)], dim=-1)
