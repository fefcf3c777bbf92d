"""Sequential (next-item) recommenders: the base and SASRec.

Counterpart of `recbox_tpu/models/sequential/models.py`
(`right_align_to_left` :40, `_last_valid` :48, `SequentialRecommender`
:54-135, `_SASRecEncoder` and `SASRec` :140-170). A model encodes the
user's left-padded item history (``item_seq`` (B, L), PAD = 0, ``seq_len``
(B,)) into one vector in item-embedding space and scores by dot product
against its own item table. Training protocols: ``full_scores`` (B, V)
logits with `ops.losses.full_softmax_loss`, and ``fused_ce_loss``, the
same CE through kernel B2 (`ops/fused_ce.py`) without the (B, V) logits.

Parameter names follow the flax tree (``emb_item``, ``sasrec.pos.pos_emb``,
``sasrec.LayerNorm_0``, ``sasrec.encoder.*``), so
`interop.from_jax_params` moves a JAX SASRec onto this one. GRU4Rec, NARM,
STAMP, Caser and NextItNet are not ported yet: they raise
NotImplementedError naming their `ROADMAP.md` item.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import MatchingModel
from recbox_tpu_torch.nn.attention import (
    LayerNorm, PositionalEmbedding, TransformerEncoder,
)
from recbox_tpu_torch.nn.core import Dropout
from recbox_tpu_torch.ops.fused_ce import fused_softmax_ce

__all__ = ["SequentialRecommender", "SASRec", "GRU4Rec", "NARM", "STAMP",
           "Caser", "NextItNet", "right_align_to_left"]


def right_align_to_left(item_seq: torch.Tensor,
                        seq_len: torch.Tensor) -> torch.Tensor:
    """Left-padded [0..0, i1..ik] rows to right-padded [i1..ik, 0..0]."""
    length = item_seq.shape[1]
    shift = (length - seq_len.to(torch.int64))[:, None]
    idx = (torch.arange(length, device=item_seq.device)[None, :] + shift) \
        % length
    return torch.gather(item_seq, 1, idx)


def _last_valid(h: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
    """h (B, L, H), right-padded → the hidden state at position seq_len−1."""
    idx = torch.clamp(seq_len.to(torch.int64) - 1, min=0)
    return h[torch.arange(h.shape[0], device=h.device), idx]


class SequentialRecommender(MatchingModel):
    """Base: owns the item table (normal(1e-4), ``emb_init``) over the
    FeatureMap's corpus_index vocabulary (ids >= 1; 0 = PAD); ``item_tower``
    is a plain lookup, so user vectors and table rows share one space.

    ``compute_dtype='bfloat16'`` runs the encoder and the full-softmax
    logits product in bf16 with f32 accumulation; parameters and the loss
    stay f32. (The JAX base also right-aligns the history for the RNN
    encoders, which are not ported yet; `right_align_to_left` and
    `_last_valid` are.)"""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot",
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        self._gen, self._dev = self.init_rng(generator, device)
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        spec = feature_map[feature_map.corpus_index]
        self.emb_item = nn.Parameter(1e-4 * torch.randn(
            spec.vocab_size, embedding_dim, generator=self._gen,
            device=self._dev))

    @property
    def _cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    def encode(self, emb: torch.Tensor, mask: torch.Tensor,
               seq_len: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def encode_sequence(self, item_seq: torch.Tensor,
                        seq_len: torch.Tensor) -> torch.Tensor:
        item_seq = item_seq.to(torch.int64)
        emb = self.emb_item[item_seq]
        mask = item_seq != 0
        emb = emb * mask[..., None].to(emb.dtype)
        return self.encode(emb, mask, seq_len)

    def user_tower(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.encode_sequence(batch["item_seq"], batch["seq_len"])

    def item_tower(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.emb_item[batch[self.feature_map.corpus_index].to(
            torch.int64)]

    def full_scores(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, vocab) f32 scores over the item vocabulary, divided by the
        temperature. In bf16 compute the operands round to bf16 and the
        product is f32: on the CPU as f32 products of the rounded values,
        on the card a bf16 `torch.matmul` (JAX leaves this product to XLA)
        with its output in f32."""
        user = self.user_tower(batch)
        u, t = user.to(self._cdtype), self.emb_item.to(self._cdtype)
        if u.dtype == torch.bfloat16 and u.device.type == "cpu":
            u, t = u.float(), t.float()
        return (u @ t.T).float() / self.temperature

    def fused_ce_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Scalar CE over the full vocabulary without the (B, vocab) logits:
        kernel B2 (`ops.fused_ce.fused_softmax_ce`) on ``user /
        temperature``. Equals ``full_softmax_loss(full_scores(batch),
        batch[corpus_index])`` under bf16 compute. Train it with an identity
        loss: ``Trainer(model, lambda out, b: out, cfg,
        train_method='fused_ce_loss')``."""
        user = self.user_tower(batch)
        return fused_softmax_ce(user / self.temperature, self.emb_item,
                                batch[self.feature_map.corpus_index])


class _SASRecEncoder(nn.Module):
    """pos-emb → LayerNorm → dropout → causal transformer; the state at the
    last position (left padding puts the most recent item there)."""

    def __init__(self, dim: int, max_seq_len: int, n_layers: int,
                 n_heads: int, dropout: float, dtype: Optional[torch.dtype],
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        self.pos = PositionalEmbedding(max_seq_len, dim, generator, device)
        self.LayerNorm_0 = LayerNorm(dim, 1e-12, device=device)
        self.drop = Dropout(dropout)
        self.encoder = TransformerEncoder(
            dim, n_layers=n_layers, n_heads=n_heads, hidden_dropout=dropout,
            attn_dropout=dropout, causal=True, dtype=dtype,
            generator=generator, device=device)

    def forward(self, emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.drop(self.LayerNorm_0(self.pos(emb)))
        return self.encoder(x, mask)[:, -1, :]


class SASRec(SequentialRecommender):
    """Self-attentive sequential recommender (recbole `sasrec.py` shape)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, n_layers: int = 2, n_heads: int = 2,
                 dropout: float = 0.2, compute_dtype: str = "float32",
                 temperature: float = 1.0, similarity: str = "dot",
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, generator,
                         device)
        self.n_layers, self.n_heads = n_layers, n_heads
        self.sasrec = _SASRecEncoder(
            embedding_dim, max_seq_len, n_layers, n_heads, dropout,
            torch.bfloat16 if compute_dtype == "bfloat16" else None,
            self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.sasrec(emb, mask)


def _not_ported(name: str):
    class _Model(SequentialRecommender):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP.md, Queue A item 8: the "
                "other sequential encoders)")
    _Model.__name__ = _Model.__qualname__ = name
    return _Model


GRU4Rec = _not_ported("GRU4Rec")
NARM = _not_ported("NARM")
STAMP = _not_ported("STAMP")
Caser = _not_ported("Caser")
NextItNet = _not_ported("NextItNet")
