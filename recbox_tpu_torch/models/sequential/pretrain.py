"""Self-supervised sequential pretraining: S3Rec and GRU4RecF.

Counterpart of `recbox_tpu/models/sequential/pretrain.py`:

* S3Rec (:34) — a bidirectional transformer (``encoder``, BERT4Rec's) over
  a (V + 1)-row item table whose last row is [MASK], pretrained on MIP
  (masked item prediction), SP (segment prediction) and, with
  ``n_attributes`` > 0, AAP / MAP (attribute association and masked
  attribute prediction) through `pretrain_losses` (:124); fine-tuning
  scores next items through a causal encoder (``causal``, with ``pos``)
  on the same table, SASRec's protocol. The pretrain phase reaches
  ``emb_item``, ``encoder``, ``sp_w`` and ``aap_w``
  (`PRETRAIN_PARAMETERS`); `training.pretrain.transfer_pretrained` grafts
  them onto a fine-tune model by name, its causal encoder keeping its
  fresh draw.
* GRU4RecF (:190) — GRU4Rec over [item emb ‖ feature emb], the feature ids
  a parallel (B, L) column (``feature_seq_name``); the GRU's input
  projections read the fused 2·D-wide input.

Parameter names follow the flax tree for `interop.from_jax_params`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.sequential.extended import _BERT4RecEncoder
from recbox_tpu_torch.models.sequential.models import (
    Device, GRU4Rec, SequentialRecommender, _last_valid, _masked_history,
    item_table, right_align_to_left,
)
from recbox_tpu_torch.nn.attention import (
    PositionalEmbedding, TransformerEncoder, dense,
)
from recbox_tpu_torch.nn.core import Dropout
from recbox_tpu_torch.nn.recurrent import GRUCell, rnn
from recbox_tpu_torch.parallel.mesh import lookup, sharded_logits

__all__ = ["S3Rec", "GRU4RecF", "PRETRAIN_PARAMETERS"]

# the S3Rec parameters the pretrain phase trains (the flax subtrees its
# pretrain_losses initializes)
PRETRAIN_PARAMETERS = ("emb_item", "encoder.", "sp_w.", "aap_w.")


def _bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, in JAX's form."""
    return (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-torch.abs(logits))))


class S3Rec(SequentialRecommender):
    """S3Rec: pretrain heads `mip_logits`, `sp_logits`, `aap_logits` and
    the joint `pretrain_losses`; the causal `user_tower` / `full_scores`
    fine-tune."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, n_layers: int = 2, n_heads: int = 2,
                 n_attributes: int = 0, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        g, dev, d = self._gen, self._dev, embedding_dim
        self.n_attributes = n_attributes
        self.emb_item = item_table(self.vocab_size + 1, d, g, dev, shard=True)
        self.encoder = _BERT4RecEncoder(d, max_seq_len, n_layers, n_heads,
                                        dropout, self._enc_dtype(), g, dev)
        self.causal = TransformerEncoder(
            d, n_layers=n_layers, n_heads=n_heads, hidden_dropout=dropout,
            attn_dropout=dropout, causal=True, dtype=self._enc_dtype(),
            generator=g, device=dev)
        self.pos = PositionalEmbedding(max_seq_len, d, g, dev)
        self.sp_w = dense(d, d, g, dev, bias=False)
        if n_attributes:
            self.aap_w = dense(d, n_attributes, g, dev, bias=False)

    @property
    def mask_token(self) -> int:
        return self.vocab_size

    def _table(self) -> torch.Tensor:
        # under a mesh the whole shard: the sharded logits leave out the
        # columns from vocab_size on, [MASK] among them
        if self._shard() is not None:
            return self.emb_item
        return self.emb_item[:self.vocab_size]

    def _bi_encode(self, seq: torch.Tensor) -> torch.Tensor:
        emb, mask = _masked_history(self.emb_item, seq, self._shard())
        return self.encoder(emb, mask)

    def user_tower(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        emb, mask = _masked_history(self.emb_item, batch["item_seq"],
                                    self._shard())
        return self.causal(self.pos(emb), mask)[:, -1, :]

    # -- pretrain heads ------------------------------------------------------
    def mip_logits(self, item_seq: torch.Tensor, seq_len: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        """(B, P, vocab) scores of the states at ``positions`` against the
        item table ([MASK] excluded). Under a mesh, as GSPMD splits JAX's
        einsum along V: `parallel.mesh.ShardedLogits` of the B·P positions
        (row b·P + p), for `vocab_parallel_ce` and
        `sharded_hit_positions`."""
        h = self._bi_encode(item_seq)
        idx = positions.to(torch.int64)[..., None].expand(-1, -1, h.shape[-1])
        g = torch.gather(h, 1, idx)
        shard = self._shard()
        if shard is not None:
            return sharded_logits(g.reshape(-1, g.shape[-1]), self._table(),
                                  shard, self.vocab_size)
        return torch.einsum("bpd,vd->bpv", g, self._table())

    def sp_logits(self, item_seq, seq_len, segment, segment_len,
                  neg_segment, neg_segment_len
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pos, neg) bilinear scores of the context's last state against
        the positive and the corrupted segment's."""
        ctx = self._bi_encode(item_seq)[:, -1, :]
        pos_r = self._bi_encode(segment)[:, -1, :]
        neg_r = self._bi_encode(neg_segment)[:, -1, :]
        w_ctx = self.sp_w(ctx)
        return (torch.sum(w_ctx * pos_r, dim=-1),
                torch.sum(w_ctx * neg_r, dim=-1))

    def aap_logits(self, item_seq: torch.Tensor, seq_len: torch.Tensor
                   ) -> torch.Tensor:
        """(B, L, n_attributes) attribute logits (AAP; MAP at masked
        positions)."""
        if not self.n_attributes:
            raise ValueError("S3Rec built with n_attributes=0")
        return self.aap_w(self._bi_encode(item_seq))

    def pretrain_losses(self, batch: Dict[str, torch.Tensor],
                        weights=(0.2, 1.0, 1.0, 0.5)) -> torch.Tensor:
        """The joint loss over a batch of `training.pretrain.
        reconstruct_pretrain_batch` (left-padded): each of AAP, MIP, MAP
        and SP a summed BCE with logits, weighted by ``weights`` = (aap,
        mip, map, sp)."""
        aap_w, mip_w, map_w, sp_w = weights
        masked_seq = batch["masked_seq"].to(torch.int64)
        h = self._bi_encode(masked_seq)
        table = self.emb_item
        mip_mask = (masked_seq == self.mask_token).float()
        valid = (masked_seq != 0).float()
        pos_e = lookup(table, batch["pos_items"].to(torch.int64),
                       self._shard(), embedding=True)
        neg_e = lookup(table, batch["neg_items"].to(torch.int64),
                       self._shard(), embedding=True)
        mip_dist = torch.sum(h * pos_e, -1) - torch.sum(h * neg_e, -1)
        mip_loss = torch.sum(_bce(mip_dist, torch.ones_like(mip_dist))
                             * mip_mask)
        loss = mip_w * mip_loss
        if self.n_attributes and "attributes" in batch:
            per_pos = torch.sum(_bce(self.aap_w(h),
                                     batch["attributes"].float()), dim=-1)
            loss = loss + aap_w * torch.sum(per_pos * valid
                                            * (1.0 - mip_mask)) \
                + map_w * torch.sum(per_pos * mip_mask)

        def last(key):
            return self._bi_encode(batch[key].to(torch.int64))[:, -1, :]

        ctx = self.sp_w(last("masked_segment"))
        sp_dist = torch.sum(ctx * last("pos_segment"), -1) \
            - torch.sum(ctx * last("neg_segment"), -1)
        sp_loss = torch.sum(_bce(sp_dist, torch.ones_like(sp_dist)))
        return loss + sp_w * sp_loss


class _GRU4RecFEncoder(nn.Module):
    """dropout → ``n_layers`` GRUs (``GRUCell_<i>``) over the fused input →
    the last valid state projected (``proj``) to D."""

    def __init__(self, in_dim: int, dim: int, hidden: int, n_layers: int,
                 dropout: float, generator, device):
        super().__init__()
        self.n_layers = n_layers
        self.drop = Dropout(dropout)
        for i in range(n_layers):
            self.add_module(f"GRUCell_{i}", GRUCell(
                in_dim if i == 0 else hidden, hidden, generator, device))
        self.proj = dense(hidden, dim, generator, device)

    def forward(self, x, seq_len):
        x = self.drop(x)
        for i in range(self.n_layers):
            x = rnn(getattr(self, f"GRUCell_{i}"), x)
        return self.proj(_last_valid(x, seq_len))


class GRU4RecF(GRU4Rec):
    """GRU4Rec with item-feature fusion: the GRU reads [item emb ‖ feature
    emb], the features from ``feature_seq_name`` (zeros where the model has
    no ``feature_vocab`` or the batch no column), the history right-padded
    first."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, hidden_size: int = 128,
                 n_layers: int = 1, feature_seq_name: str = "feat_seq",
                 feature_vocab: int = 0, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        SequentialRecommender.__init__(
            self, feature_map, embedding_dim, max_seq_len, dropout,
            compute_dtype, temperature, similarity, right_align, generator,
            device)
        g, dev, d = self._gen, self._dev, embedding_dim
        self.feature_seq_name = feature_seq_name
        self.feature_vocab = feature_vocab
        if feature_vocab:
            self.emb_feat = item_table(feature_vocab, d, g, dev, shard=True)
        self.gru4recf = _GRU4RecFEncoder(2 * d, d, hidden_size, n_layers,
                                         dropout, g, dev)

    def user_tower(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        seq_len = batch["seq_len"]
        seq = right_align_to_left(batch["item_seq"].to(torch.int64), seq_len)
        mask = seq != 0
        emb = lookup(self._table(), seq, self._shard(), embedding=True)
        if self.feature_vocab and self.feature_seq_name in batch:
            fseq = right_align_to_left(
                batch[self.feature_seq_name].to(torch.int64), seq_len)
            femb = lookup(self.emb_feat, fseq, embedding=True)
        else:
            femb = torch.zeros_like(emb)
        x = torch.cat([emb, femb], dim=-1) * mask[..., None].to(emb.dtype)
        return self.gru4recf(x, seq_len)
