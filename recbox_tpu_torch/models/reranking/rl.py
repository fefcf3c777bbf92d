"""Generative / RL rerankers: the EGR evaluator and discriminator, a PPO
pointer policy, and their losses.

Counterpart of `recbox_tpu/models/reranking/rl.py` (`EGREvaluator` :30,
`EGRDiscriminator` :73, `PPOReranker` :92, `list_reward_ndcg` :204,
`reinforce_loss` :226, `ppo_loss` :236). A model maps ``(item_feats (B, N,
D), mask (B, N) bool)`` to (B, N) scores, or one logit a list for the
discriminator. Submodules carry the flax names (``proj``, ``GRUCell_0`` /
``GRUCell_1`` (the cells ``nn.RNN`` scans, which flax names in the model's
scope), ``score``, ``head``, ``cell``, ``att_c`` / ``att_h`` / ``att_v``,
``value``), so `interop.from_jax_params` moves a flax tree over.

The pointer decoder is JAX's ``lax.scan`` as a loop over the N positions,
with no host sync inside it: each step attends the remaining candidates
against a GRU state over the emitted prefix, picks one (argmax, or a draw)
and masks it out. Once the valid candidates run out, the padded slots are
emitted, so every output is a permutation of 0..N−1 (`rl.py:128-131`).
`PPOReranker.rollout` draws its categorical by Gumbel-max, as
``jax.random.categorical`` does, from uniforms of an explicit
``torch.Generator``: the draws are the categorical's, but not JAX's stream
(`ROADMAP.md` Queue C, entry 43).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from recbox_tpu_torch.models.reranking.models import Device, _Reranker
from recbox_tpu_torch.nn.attention import dense
from recbox_tpu_torch.nn.core import MLP, Dropout
from recbox_tpu_torch.nn.recurrent import GRUCell, rnn, take_steps

__all__ = ["EGREvaluator", "EGRDiscriminator", "PPOReranker",
           "reinforce_loss", "ppo_loss", "list_reward_ndcg"]


class EGREvaluator(_Reranker):
    """List evaluator: ``proj``, then a forward GRU (``GRUCell_0``) and a
    length-aware backward one (``GRUCell_1``) over the list rolled so its
    valid slots form a prefix (a pre-padded list's too), rolled back,
    dropout, then a per-item click logit (``score``). Slots outside the
    mask get the values JAX's model gives them."""

    def __init__(self, in_dim: int, d_model: int = 64, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(generator, device)
        g, dev = self._gen, self._dev
        self.proj = dense(in_dim, d_model, g, dev)
        self.GRUCell_0 = GRUCell(d_model, d_model, g, dev)
        self.GRUCell_1 = GRUCell(d_model, d_model, g, dev)
        self.drop = Dropout(dropout)
        self.score = dense(2 * d_model, 1, g, dev)

    def forward(self, item_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        x = self.proj(item_feats)
        n = x.shape[1]
        valid = mask.to(torch.int32)
        lengths = torch.sum(valid, dim=-1)
        lead = torch.argmax(valid, dim=-1)
        pos = torch.arange(n, device=x.device)[None, :]
        xp = take_steps(x, (pos + lead[:, None]) % n)
        h = torch.cat([rnn(self.GRUCell_0, xp),
                       rnn(self.GRUCell_1, xp, lengths, reverse=True)],
                      dim=-1)
        h = self.drop(take_steps(h, (pos - lead[:, None]) % n))
        return self.score(h)[..., 0]

    def list_value(self, item_feats: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
        """Expected list reward: the masked mean click probability (B,)."""
        scores = self(item_feats, mask)
        m = mask.to(scores.dtype)
        return torch.sum(torch.sigmoid(scores) * m, dim=-1) / torch.clamp(
            torch.sum(m, dim=-1), min=1.0)


class EGRDiscriminator(_Reranker):
    """Order discriminator: ``proj``, a GRU (``GRUCell_0``) over the whole
    list, the mean of its states over the valid slots, an MLP ``head``:
    one logit a list (B,)."""

    def __init__(self, in_dim: int, d_model: int = 64,
                 hidden_units: Sequence[int] = (64, 32),
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(generator, device)
        g, dev = self._gen, self._dev
        self.proj = dense(in_dim, d_model, g, dev)
        self.GRUCell_0 = GRUCell(d_model, d_model, g, dev)
        self.head = MLP(d_model, tuple(hidden_units), output_dim=1,
                        dropout=dropout, generator=g, device=dev)

    def forward(self, item_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        h = rnn(self.GRUCell_0, self.proj(item_feats))
        m = mask[..., None].to(h.dtype)
        pooled = torch.sum(h * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                       min=1.0)
        return self.head(pooled)[..., 0]


class PPOReranker(_Reranker):
    """Pointer-decoder policy: emits a permutation of the list one position
    at a time. `rollout` samples (perm, log-probs, value); the forward is
    the greedy decode as scores (N − emit position, −1e9 off the mask),
    which carry no gradient, as JAX's; `evaluate_actions` re-scores a given
    permutation (the PPO update's pass). ``max_list_len`` is JAX's field,
    unused there too."""

    def __init__(self, in_dim: int, d_model: int = 64,
                 max_list_len: int = 30,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(generator, device)
        g, dev = self._gen, self._dev
        self.max_list_len = max_list_len
        self.proj = dense(in_dim, d_model, g, dev)
        self.cell = GRUCell(d_model, d_model, g, dev)
        self.att_c = dense(d_model, d_model, g, dev, bias=False)
        self.att_h = dense(d_model, d_model, g, dev, bias=False)
        self.att_v = dense(d_model, 1, g, dev, bias=False)
        self.value = dense(d_model, 1, g, dev)

    def _decode(self, item_feats, mask, choose):
        """The scan: ``choose(t, logits)`` picks step t's slot; returns the
        (B, N) picks, their log-probs, the per-step entropies over the
        selectable slots, and the value of the final state."""
        cand = self.proj(item_feats)                          # (B, N, D)
        b, n, _ = cand.shape
        h = torch.mean(cand * mask[..., None].to(cand.dtype), dim=1)
        keys = self.att_c(cand)
        rows = torch.arange(b, device=cand.device)
        slots = torch.arange(n, device=cand.device)[None, :]
        picked = torch.zeros_like(mask)
        perm, logps, ents = [], [], []
        for t in range(n):
            avail = mask & ~picked
            sel = torch.where(torch.any(avail, dim=-1, keepdim=True), avail,
                              ~picked)
            e = torch.tanh(keys + self.att_h(h)[:, None])
            logits = torch.where(sel, self.att_v(e)[..., 0],
                                 torch.full_like(e[..., 0], -1e9))
            choice = choose(t, logits)
            logp_all = torch.log_softmax(logits, dim=-1)
            logps.append(logp_all[rows, choice])
            ents.append(-torch.sum(torch.exp(logp_all) * logp_all
                                   * sel.to(logp_all.dtype), dim=-1))
            h = self.cell(h, cand[rows, choice])
            picked = picked | (slots == choice[:, None])
            perm.append(choice)
        return (torch.stack(perm, dim=1), torch.stack(logps, dim=1),
                torch.stack(ents, dim=1), self.value(h)[..., 0])

    def rollout(self, item_feats: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sample a permutation: perm (B, N) slot indices by emitted
        position, per-step log-probs (B, N), critic value (B,). Each step's
        categorical is Gumbel-max over uniforms from ``generator``."""
        tiny = torch.finfo(torch.float32).tiny

        def draw(t, logits):
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device).clamp_(min=tiny)
            return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

        perm, logp, _, value = self._decode(item_feats, mask, draw)
        return perm, logp, value

    def forward(self, item_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """Greedy scores: items emitted earlier score higher (N − emit
        position), −1e9 on invalid slots."""
        with torch.no_grad():
            perm, _, _, _ = self._decode(
                item_feats, mask, lambda t, logits: torch.argmax(logits, -1))
        b, n = perm.shape
        pos = torch.zeros((b, n), dtype=torch.float32, device=perm.device)
        pos.scatter_(1, perm, torch.arange(
            n, dtype=torch.float32, device=perm.device).expand(b, n))
        return torch.where(mask, n - pos, torch.full_like(pos, -1e9))

    def evaluate_actions(self, item_feats: torch.Tensor, mask: torch.Tensor,
                         perm: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Log-probs (B, N), masked entropies (B, N) and the value (B,) of
        a given permutation under the current policy."""
        perm = perm.to(torch.int64)
        _, logp, ent, value = self._decode(item_feats, mask,
                                           lambda t, logits: perm[:, t])
        return logp, ent, value


def list_reward_ndcg(perm: torch.Tensor, labels: torch.Tensor,
                     mask: torch.Tensor, k: int = 10) -> torch.Tensor:
    """NDCG@k of an emitted permutation against per-item labels (B,)."""
    n = perm.shape[1]
    rel = labels * mask.to(labels.dtype)
    lab = torch.gather(rel, 1, perm.to(torch.int64))
    pos = torch.arange(n, device=perm.device, dtype=labels.dtype)
    disc = torch.where(pos < k, 1.0 / torch.log2(pos + 2.0),
                       torch.zeros_like(pos))
    dcg = torch.sum(lab * disc[None, :], dim=-1)
    ideal = torch.sort(rel, dim=-1, descending=True).values
    idcg = torch.sum(ideal * disc[None, :], dim=-1)
    return dcg / torch.clamp(idcg, min=1e-9)


def _masked_sum(logp: torch.Tensor, step_mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Per-step log-probs summed over the valid decode steps only: a slate
    shorter than N emits filler picks of padded slots, whose log-probs
    must not drive gradients."""
    if step_mask is None:
        return torch.sum(logp, dim=-1)
    return torch.sum(logp * step_mask.to(logp.dtype), dim=-1)


def reinforce_loss(logp: torch.Tensor, reward: torch.Tensor,
                   baseline: Optional[torch.Tensor] = None,
                   step_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """REINFORCE with an optional baseline; ``step_mask`` (B, N) flags the
    valid (non-filler) decode steps."""
    adv = reward if baseline is None else reward - baseline
    return -torch.mean(_masked_sum(logp, step_mask) * adv.detach())


def ppo_loss(logp_new: torch.Tensor, logp_old: torch.Tensor,
             advantage: torch.Tensor, value: torch.Tensor,
             reward: torch.Tensor, clip_eps: float = 0.2,
             vf_coef: float = 0.5, ent_coef: float = 0.0,
             entropy: Optional[torch.Tensor] = None,
             step_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clipped PPO objective: a per-list ratio over the summed step
    log-probs, value MSE, an optional entropy bonus; ``step_mask`` as in
    `reinforce_loss`."""
    ratio = torch.exp(_masked_sum(logp_new - logp_old, step_mask))
    adv = advantage.detach()
    pg = -torch.mean(torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv))
    vf = torch.mean(torch.square(value - reward))
    ent = 0.0 if entropy is None else -torch.mean(
        _masked_sum(entropy, step_mask))
    return pg + vf_coef * vf + ent_coef * ent
