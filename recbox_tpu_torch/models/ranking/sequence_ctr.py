"""Sequence-aware CTR models: DIN, BST, DIEN and DSIN.

Counterpart of `recbox_tpu/models/ranking/sequence_ctr.py` (`DIN` :33,
`BST` :73, `_AUGRUCell` :116, `DIEN` :145 with `auxiliary_logits` :220,
`DSIN` :238). Every model embeds the batch unpooled (``embedding``), reads
the behaviour sequence ``history_feature`` (B, L, D) and the candidate
``target_feature`` (B, D), which share one table, and feeds the rest of
the features, flat, beside the pooled sequence into a deep tower
(``dnn``). The sequence's PAD id is its ``padding_idx``, else
``vocab_size − 1``: histories are pre-padded with the table's last row.

Submodules carry the flax names (``attention``, ``pos``, ``encoder``,
``gru1.cell`` / ``augru.cell`` (``nn.RNN``'s cell), ``att``,
``session_att``, ``GRUCell_0`` / ``GRUCell_1`` (DSIN's forward and
backward cells, which flax names in the model's scope), ``act1`` /
``act2``), so `interop.from_jax_params` moves a JAX model's params and
``batch_stats`` (the Dice statistics) over.

Where JAX asserts, the port raises ValueError: DIEN's ``gru_hidden`` must
equal ``embedding_dim`` and DSIN's history length must divide into
``session_count``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import RankingModel
from recbox_tpu_torch.nn.attention import (
    PositionalEmbedding, TargetAttention, TransformerEncoder, dense,
)
from recbox_tpu_torch.nn.core import MLP
from recbox_tpu_torch.nn.embedding import FeatureEmbedding, concat_embeddings
# flip_sequences lives in nn/recurrent.py, which DSIN and the EGR models
# share; it stays importable from here
from recbox_tpu_torch.nn.recurrent import (  # noqa: F401
    GRUCell, flip_sequences, rnn, take_steps,
)

__all__ = ["DIN", "BST", "DIEN", "DSIN"]

Device = Optional[Union[str, torch.device]]


class _SequenceCTR(RankingModel):
    """The unpooled ``embedding``, the history's mask and the flat rest."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int,
                 history_feature: str, target_feature: str,
                 generator: Optional[torch.Generator], device: Device):
        super().__init__(feature_map)
        self._gen, self._dev = self.init_rng(generator, device)
        self.embedding_dim = embedding_dim
        self.history_feature = history_feature
        self.target_feature = target_feature
        self.embedding = FeatureEmbedding(
            feature_map, embedding_dim=embedding_dim, sequence_pooling=False,
            name="embedding", generator=self._gen, device=self._dev)
        spec = feature_map[history_feature]
        self.pad = spec.padding_idx if spec.padding_idx is not None \
            else spec.vocab_size - 1
        self.hist_len = spec.max_len
        # width of the flat features beside the history
        self.other_dim = self.embedding.out_dim - embedding_dim * spec.max_len

    def _mlp(self, in_dim: int, hidden_units, **kw) -> MLP:
        return MLP(in_dim, tuple(hidden_units), generator=self._gen,
                   device=self._dev, **kw)

    def _embed(self, batch):
        embs = self.embedding(batch)
        return embs, batch[self.history_feature] != self.pad

    def _other(self, embs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = tuple(f for f in self.feature_map.input_features
                      if f.name != self.history_feature)
        return concat_embeddings(
            {k: v for k, v in embs.items() if k != self.history_feature},
            feats)


class DIN(_SequenceCTR):
    """Deep interest network: target attention (``attention``) pools the
    behaviour sequence against the candidate."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 history_feature: str = "hist",
                 target_feature: str = "item_id",
                 attention_hidden_units: Sequence[int] = (80, 40),
                 attention_activation: str = "dice",
                 attention_use_softmax: bool = False,
                 hidden_units: Sequence[int] = (200, 80),
                 activation: str = "relu", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, history_feature,
                         target_feature, generator, device)
        self.attention = TargetAttention(
            embedding_dim, attention_hidden_units, attention_activation,
            attention_use_softmax, self._gen, self._dev)
        self.dnn = self._mlp(self.other_dim + embedding_dim, hidden_units,
                             activation=activation, output_dim=1,
                             dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        embs, mask = self._embed(batch)
        pooled = self.attention(embs[self.target_feature],
                                embs[self.history_feature], mask)
        x = torch.cat([self._other(embs), pooled], dim=-1)
        return self.dnn(x).reshape(-1)


class BST(_SequenceCTR):
    """Behaviour sequence transformer: self-attention over [history ‖
    candidate] with learned positions (``pos``), the masked states flat
    into the tower."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 history_feature: str = "hist",
                 target_feature: str = "item_id", n_layers: int = 1,
                 n_heads: int = 2, hidden_units: Sequence[int] = (200, 80),
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, history_feature,
                         target_feature, generator, device)
        g, dev, d = self._gen, self._dev, embedding_dim
        self.pos = PositionalEmbedding(self.hist_len + 1, d, g, dev)
        self.encoder = TransformerEncoder(
            d, n_layers=n_layers, n_heads=n_heads, hidden_dropout=dropout,
            attn_dropout=dropout, generator=g, device=dev)
        self.dnn = self._mlp(self.other_dim + (self.hist_len + 1) * d,
                             hidden_units, output_dim=1, dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        embs, mask = self._embed(batch)
        hist = embs[self.history_feature]
        mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
        seq = self.pos(torch.cat(
            [hist, embs[self.target_feature][:, None, :]], dim=1))
        enc = self.encoder(seq, mask) * mask[..., None].to(seq.dtype)
        x = torch.cat([self._other(embs), enc.reshape(enc.shape[0], -1)],
                      dim=-1)
        return self.dnn(x).reshape(-1)


class _Scan(nn.Module):
    """flax ``nn.RNN``'s scope: the scanned ``cell``."""

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.cell = cell


class _AUGRUCell(nn.Module):
    """DIEN's attention-gated GRU: the update gate scaled by the attention
    score a, z' = a·z, h' = (1 − z')·h + z'·n. Unlike flax's ``GRUCell``
    (`nn.recurrent.GRUCell`), ``hn`` has no bias and every kernel is a
    plain lecun-normal ``Dense``."""

    def __init__(self, dim: int, generator, device):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, dense(dim, dim, generator, device))
        for name in ("hr", "hz", "hn"):
            self.add_module(name, dense(dim, dim, generator, device,
                                        bias=False))

    def scan(self, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        """(B, L, H) inputs and (B, L, 1) scores → the (B, L, H) states
        from a zero carry."""
        xr, xz, xn = self.ir(x), self.iz(x), getattr(self, "in")(x)
        h = torch.zeros_like(xr[:, 0])
        out = []
        for t in range(x.shape[1]):
            r = torch.sigmoid(xr[:, t] + self.hr(h))
            z = torch.sigmoid(xz[:, t] + self.hz(h))
            n = torch.tanh(xn[:, t] + r * self.hn(h))
            z = att[:, t] * z
            h = (1.0 - z) * h + z * n
            out.append(h)
        return torch.stack(out, dim=1)


class DIEN(_SequenceCTR):
    """Deep interest evolution network: an extraction GRU (``gru1``) over
    the behaviour sequence, target-attention scores (``att``, a masked
    softmax zeroed again at PAD) gating an AUGRU (``augru``) whose last
    state is the evolved interest. `auxiliary_logits` are the inputs of
    DIEN's auxiliary loss."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 history_feature: str = "hist",
                 target_feature: str = "item_id", gru_hidden: int = 16,
                 hidden_units: Sequence[int] = (200, 80),
                 activation: str = "dice", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        if gru_hidden != embedding_dim:
            # the attention compares target embeddings with GRU states and
            # the auxiliary loss dots interest states with behaviours
            raise ValueError(f"DIEN requires gru_hidden == embedding_dim "
                             f"({gru_hidden} != {embedding_dim})")
        super().__init__(feature_map, embedding_dim, history_feature,
                         target_feature, generator, device)
        g, dev, h = self._gen, self._dev, gru_hidden
        self.gru_hidden = h
        self.gru1 = _Scan(GRUCell(embedding_dim, h, g, dev))
        self.att = self._mlp(3 * h, (80, 40), activation="sigmoid",
                             output_dim=1)
        self.augru = _Scan(_AUGRUCell(h, g, dev))
        self.dnn = self._mlp(self.other_dim + h, hidden_units,
                             activation=activation, output_dim=1,
                             dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        embs, mask = self._embed(batch)
        interest = rnn(self.gru1.cell, embs[self.history_feature])
        t = embs[self.target_feature][:, None, :self.gru_hidden]
        att_in = torch.cat([interest, t.expand_as(interest), interest * t],
                           dim=-1)
        scores = self.att(att_in)[..., 0]
        scores = torch.softmax(torch.where(
            mask, scores, torch.full_like(scores, -1e9)), dim=-1)
        scores = torch.where(mask, scores, torch.zeros_like(scores))
        evolved = self.augru.cell.scan(interest, scores[..., None])
        x = torch.cat([self._other(embs), evolved[:, -1, :]], dim=-1)
        return self.dnn(x).reshape(-1)

    def auxiliary_logits(self, batch, neg_hist_feature: str = "neg_hist"
                         ) -> torch.Tensor:
        """(B, L − 1, 2) logits: interest state t against behaviour t + 1
        and against the negative at t + 1 (the ``neg_hist_feature`` column,
        else the previous row's history, ``roll(hist, 1)`` over the
        batch)."""
        embs, _ = self._embed(batch)
        hist = embs[self.history_feature]
        interest = rnn(self.gru1.cell, hist)
        neg = embs.get(neg_hist_feature)
        if neg is None:
            neg = torch.roll(hist, 1, dims=0)
        h = interest[:, :-1, :self.embedding_dim]
        return torch.stack([torch.sum(h * hist[:, 1:], dim=-1),
                            torch.sum(h * neg[:, 1:], dim=-1)], dim=-1)


class DSIN(_SequenceCTR):
    """Deep session interest network: the history cut into
    ``session_count`` sessions, a per-session transformer
    (``session_att``) averaged over each session's valid steps, a
    bidirectional GRU over the valid sessions, two target attentions
    (``act1`` over the session interests, ``act2`` over their evolution).

    The bidirectional GRU is flax's ``nn.RNN`` with ``seq_lengths``: each
    row is rolled so its valid sessions form a prefix; the forward cell
    (``GRUCell_0``) scans all S steps, the backward one (``GRUCell_1``)
    scans the row with its valid prefix reversed and is flipped back
    (`nn.recurrent.rnn` with ``reverse``), and the sum rolls back into
    place."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 history_feature: str = "hist",
                 target_feature: str = "item_id", session_count: int = 5,
                 n_heads: int = 2, hidden_units: Sequence[int] = (200, 80),
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, history_feature,
                         target_feature, generator, device)
        if self.hist_len % session_count:
            raise ValueError(
                f"DSIN: history length {self.hist_len} must divide into "
                f"session_count={session_count}")
        g, dev, d = self._gen, self._dev, embedding_dim
        self.session_count = session_count
        self.session_att = TransformerEncoder(
            d, n_layers=1, n_heads=n_heads, hidden_dropout=dropout,
            attn_dropout=dropout, generator=g, device=dev)
        self.GRUCell_0 = GRUCell(d, d, g, dev)
        self.GRUCell_1 = GRUCell(d, d, g, dev)
        self.act1 = TargetAttention(d, use_softmax=True, generator=g,
                                    device=dev)
        self.act2 = TargetAttention(d, use_softmax=True, generator=g,
                                    device=dev)
        self.dnn = self._mlp(self.other_dim + 2 * d, hidden_units,
                             output_dim=1, dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        embs, mask = self._embed(batch)
        hist = embs[self.history_feature]
        target = embs[self.target_feature]
        b, length, d = hist.shape
        s = self.session_count
        k = length // s
        sess_mask = mask.reshape(b * s, k)
        enc = self.session_att(hist.reshape(b * s, k, d), sess_mask)
        w = sess_mask[..., None].to(enc.dtype)
        interest = (torch.sum(enc * w, dim=1) / torch.clamp(
            torch.sum(w, dim=1), min=1e-12)).reshape(b, s, d)
        sess_valid = mask.reshape(b, s, k).any(-1)
        sess_len = sess_valid.sum(-1)
        lead = torch.argmax(sess_valid.to(torch.int32), dim=-1)
        pos = torch.arange(s, device=hist.device)[None, :]
        pre = take_steps(interest, (pos + lead[:, None]) % s)
        fwd = rnn(self.GRUCell_0, pre)
        bwd = rnn(self.GRUCell_1, pre, sess_len, reverse=True)
        evolved = take_steps(fwd + bwd, (pos - lead[:, None]) % s)
        att1 = self.act1(target, interest, sess_valid)
        att2 = self.act2(target, evolved, sess_valid)
        x = torch.cat([self._other(embs), att1, att2], dim=-1)
        return self.dnn(x).reshape(-1)
