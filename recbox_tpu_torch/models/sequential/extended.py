"""The extended sequential zoo: BERT4Rec, FPMC, TransRec, HGN, SHAN,
FOSSIL, HRM, NPE, CORE, LightSANs, FDSA, RepeatNet and SINE.

Counterpart of `recbox_tpu/models/sequential/extended.py` (:52-791). Every
model subclasses `SequentialRecommender`: the history is a left-padded
``item_seq`` (B, L) with PAD = 0 plus ``seq_len`` (B,); the models that
condition on the user read ``user_id`` (B,) and take ``num_users``.
Scoring is a dot product against ``_table()``. TransRec's translation
distance and FOSSIL's item bias become dot products by augmenting the
table with norm / bias columns and the user vector with constants (per-row
constants cancel in the softmax and BPR losses, JAX :12-19).

- BERT4Rec keeps a (V + 1)-row table, [MASK] = V; ``user_tower`` shifts
  the history left and appends [MASK] (:113-121); `masked_item_scores`
  gives the cloze logits, `fused_cloze_loss` the cloze CE through kernel
  B2 (`ops.fused_ce.fused_softmax_ce`) with per-row weights over the first
  V rows, so the [MASK] row gets no gradient from the output side and a
  row of weight 0 adds nothing to the loss or the gradients.
- CORE scores by cosine at temperature 0.07 (its own `full_scores`,
  :490); RepeatNet's `full_scores` is the log of its repeat / explore
  mixture (:730) and it has no single user vector (``user_tower`` and so
  ``fused_ce_loss`` raise, :733).
- FDSA's feature stream embeds the ``feature_seq_name`` column (B, L)
  when ``feature_vocab`` > 0, else a learned projection of the item
  embeddings. Where JAX falls back to the projection when the column is
  absent (a flax model then holds the parameters its first call made),
  the port's model with ``feature_vocab`` > 0 needs the column and raises
  KeyError without it.
- ``compute_dtype='bfloat16'`` reaches the transformer encoders of
  BERT4Rec, CORE and FDSA (LightSANs' own layers stay f32, as in JAX).

Under a mesh the tables JAX partitions row-shard (`item_table(...,
shard=True)`: the item, user, feature and output tables); TransRec's and
FOSSIL's replicated ``bias_item`` join the sharded scoring table through
`parallel.mesh.shard_slice`; BERT4Rec's [MASK] row stays in its shard and
out of the scored columns; RepeatNet's mixture stays whole (`ROADMAP.md`
Queue C 60); the cloze heads raise.

Parameter names follow the flax tree, so `interop.from_jax_params` fills
them: the tables (``emb_item``, ``emb_item_li``, ``emb_user``,
``bias_item``, ``emb_eta_user``, ...), each encoder's Dense layers by
their flax names, DenseGeneral heads as one Linear (LightSANs' ``q``,
``k``, ``v``, ``theta``, ``pq``, ``pk``), SINE's ``prototypes`` and
LightSANs' ``pos`` as bare parameters.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.sequential.models import (
    Device, SequentialRecommender, _last_valid, _masked_history,
    item_table, right_align_to_left,
)
from recbox_tpu_torch.nn.attention import (
    LayerNorm, PositionalEmbedding, TransformerEncoder, dense,
)
from recbox_tpu_torch.nn.core import Dropout
from recbox_tpu_torch.nn.recurrent import GRUCell, rnn
from recbox_tpu_torch.ops.fused_ce import fused_softmax_ce
from recbox_tpu_torch.parallel.mesh import (
    lookup, shard_slice, sharded_logits,
)

__all__ = ["BERT4Rec", "FPMC", "TransRec", "HGN", "SHAN", "FOSSIL", "HRM",
           "NPE", "CORE", "LightSANs", "FDSA", "RepeatNet", "SINE",
           "masked_softmax"]


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """softmax with masked entries at −1e9 (never −inf: an all-masked row
    comes out uniform, not NaN)."""
    return torch.softmax(torch.where(mask, logits,
                                     torch.full_like(logits, -1e9)), dim=dim)


def _seq_args(kw: dict) -> dict:
    """The base's arguments out of a model's constructor locals."""
    return {k: kw[k] for k in (
        "feature_map", "embedding_dim", "max_seq_len", "dropout",
        "compute_dtype", "temperature", "similarity", "right_align",
        "generator", "device")}


# -- BERT4Rec -----------------------------------------------------------------

class _BERT4RecEncoder(nn.Module):
    """pos-emb → LayerNorm → dropout → bidirectional transformer; every
    position's state."""

    def __init__(self, dim, max_seq_len, n_layers, n_heads, dropout, dtype,
                 generator, device):
        super().__init__()
        self.pos = PositionalEmbedding(max_seq_len, dim, generator, device)
        self.LayerNorm_0 = LayerNorm(dim, 1e-12, device=device)
        self.drop = Dropout(dropout)
        self.encoder = TransformerEncoder(
            dim, n_layers=n_layers, n_heads=n_heads, hidden_dropout=dropout,
            attn_dropout=dropout, causal=False, dtype=dtype,
            generator=generator, device=device)

    def forward(self, emb, mask):
        return self.encoder(self.drop(self.LayerNorm_0(self.pos(emb))), mask)


class BERT4Rec(SequentialRecommender):
    """Bidirectional encoder with cloze training (`bert4rec.py` shape).

    The item table carries one extra row, the [MASK] token (id =
    ``vocab_size``). Next-item inference appends [MASK] to the history and
    reads the state at that position; cloze training scores externally
    sampled masked positions (`masked_item_scores`, `fused_cloze_loss`)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, n_layers: int = 2, n_heads: int = 2,
                 dropout: float = 0.2, compute_dtype: str = "float32",
                 temperature: float = 1.0, similarity: str = "dot",
                 right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.emb_item = item_table(self.vocab_size + 1, embedding_dim,
                                   self._gen, self._dev,
                                   shard=True)                # +1 = [MASK]
        self.bert4rec = _BERT4RecEncoder(
            embedding_dim, max_seq_len, n_layers, n_heads, dropout,
            self._enc_dtype(), self._gen, self._dev)

    @property
    def mask_token(self) -> int:
        return self.vocab_size

    def _table(self) -> torch.Tensor:
        # under a mesh the whole shard: the sharded logits leave out the
        # columns from vocab_size on, [MASK] among them
        if self._shard() is not None:
            return self.emb_item
        return self.emb_item[:self.vocab_size]

    def _encode(self, item_seq, seq_len):
        emb, mask = _masked_history(self.emb_item, item_seq, self._shard())
        return self.bert4rec(emb, mask)

    def user_tower(self, batch):
        # [0,..,i1..ik] → [0,..,i1..ik,MASK], the oldest slot dropped when
        # full (recbole's reconstruct_test_data)
        item_seq = batch["item_seq"].to(torch.int64)
        mask_col = torch.full((item_seq.shape[0], 1), self.mask_token,
                              dtype=item_seq.dtype, device=item_seq.device)
        shifted = torch.cat([item_seq[:, 1:], mask_col], dim=1)
        return self._encode(shifted, batch["seq_len"] + 1)[:, -1, :]

    def _gathered(self, item_seq, seq_len, positions):
        h = self._encode(item_seq, seq_len)
        idx = positions.to(torch.int64)[..., None].expand(
            -1, -1, h.shape[-1])
        return torch.gather(h, 1, idx)                         # (B, P, D)

    def masked_item_scores(self, item_seq, seq_len, positions):
        """Cloze logits: ``item_seq`` already holds [MASK] at ``positions``
        (B, P); (B, P, vocab) f32 scores at those positions. Under a mesh,
        as GSPMD splits JAX's einsum along V: `parallel.mesh.ShardedLogits`
        of the B·P positions (row b·P + p), for `vocab_parallel_ce` (with
        the positions' weights) and `sharded_hit_positions`."""
        g = self._gathered(item_seq, seq_len, positions)
        shard = self._shard()
        if shard is not None:
            return sharded_logits(g.reshape(-1, g.shape[-1]).float(),
                                  self._table().float(), shard,
                                  self.vocab_size)
        return torch.einsum("bpd,vd->bpv", g.float(), self._table().float())

    def fused_cloze_loss(self, item_seq, seq_len, positions, labels,
                         weights=None):
        """Cloze CE over the full vocabulary without the (B, P, vocab)
        logits: the (B, P) positions flatten to B·P rows of kernel B2
        against the first V table rows; ``weights`` (B, P) masks pad
        positions exactly (a row of weight 0 is a no-op in the loss and
        the gradients). A single-shard path: it raises under a mesh, as
        JAX's flash-CE is a single-shard op and its trainer refuses it
        under a mesh."""
        if self._shard() is not None:
            raise NotImplementedError(
                "BERT4Rec.fused_cloze_loss under a mesh: kernel B2 is a "
                "single-shard op, as JAX's flash-CE "
                "(recbox_tpu/ops/pallas/fused_ce.py:386-387); train through "
                "masked_item_scores + vocab_parallel_ce")
        g = self._gathered(item_seq, seq_len, positions)
        flat = g.reshape(-1, g.shape[-1])
        w = None if weights is None else weights.reshape(-1)
        return fused_softmax_ce(flat, self._table(),
                                labels.reshape(-1).to(torch.int64), w)


# -- the user-conditioned shallow models --------------------------------------

class FPMC(SequentialRecommender):
    """score(u, last, i) = ⟨V_ui(u), V_iu(i)⟩ + ⟨V_il(last), V_li(i)⟩
    (`fpmc.py` shape): the two item-side factors concatenated into one
    2D-wide scoring table."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, num_users: int = 0,
                 dropout: float = 0.2, compute_dtype: str = "float32",
                 temperature: float = 1.0, similarity: str = "dot",
                 right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        g, dev, v, d = self._gen, self._dev, self.vocab_size, embedding_dim
        self.emb_item_li = item_table(v, d, g, dev, shard=True)   # V_li
        self.emb_item_il = item_table(v, d, g, dev, shard=True)   # V_il
        self.emb_user = item_table(num_users, d, g, dev,
                                   shard=True)                    # V_ui

    def _table(self):
        return torch.cat([self.emb_item, self.emb_item_li], dim=1)

    def user_tower(self, batch):
        u = lookup(self.emb_user, batch["user_id"].to(torch.int64))
        last = lookup(self.emb_item_il,
                          batch["item_seq"][:, -1].to(torch.int64))
        return torch.cat([u, last], dim=-1)


class TransRec(SequentialRecommender):
    """score = b_i − ‖t_u + e_last − e_i‖² (`transrec.py` shape), expanded
    to 2(t_u + e_last)·e_i − ‖e_i‖² + b_i (the user constant dropped): the
    table gains [−‖e‖², b] columns, the user vector [1, 1]."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, num_users: int = 0,
                 dropout: float = 0.2, compute_dtype: str = "float32",
                 temperature: float = 1.0, similarity: str = "dot",
                 right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.emb_user = item_table(num_users, embedding_dim, self._gen,
                                   self._dev, shard=True)
        self.bias_item = nn.Parameter(torch.zeros(self.vocab_size, 1,
                                                  device=self._dev))

    def _table(self):
        e = self.emb_item
        sq = -torch.sum(e * e, dim=1, keepdim=True)
        # the bias replicates (JAX leaves it unpartitioned): its rows of
        # this rank's shard
        return torch.cat([e, sq, shard_slice(self.bias_item, self._shard())],
                         dim=1)

    def user_tower(self, batch):
        x = lookup(self.emb_user, batch["user_id"].to(torch.int64)) \
            + lookup(self.emb_item,
                         batch["item_seq"][:, -1].to(torch.int64))
        ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
        return torch.cat([2.0 * x, ones, ones], dim=-1)


class _HGNEncoder(nn.Module):
    def __init__(self, dim, max_seq_len, generator, device):
        super().__init__()
        g = generator
        self.w1 = dense(dim, dim, g, device)
        self.w2 = dense(dim, dim, g, device, bias=False)
        self.w3 = dense(dim, 1, g, device, bias=False)
        self.w4 = dense(dim, max_seq_len, g, device, bias=False)

    def forward(self, emb, mask, user_emb):
        # feature gating, then instance gating (`hgn.py`)
        gated = emb * torch.sigmoid(self.w1(emb) + self.w2(user_emb)[:, None])
        g2 = torch.sigmoid(self.w3(gated)[..., 0] + self.w4(user_emb)) \
            * mask.to(emb.dtype)
        denom = torch.clamp(torch.sum(g2, dim=1, keepdim=True), min=1e-12)
        return torch.einsum("bl,bld->bd", g2, gated) / denom


class HGN(SequentialRecommender):
    """Hierarchical gating (`hgn.py` shape): feature gate → instance gate
    → average pool; the user vector is u + pooled + Σ history (the
    item-item product folded in)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, num_users: int = 0,
                 dropout: float = 0.2, compute_dtype: str = "float32",
                 temperature: float = 1.0, similarity: str = "dot",
                 right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.emb_user = item_table(num_users, embedding_dim, self._gen,
                                   self._dev, shard=True)
        self.hgn = _HGNEncoder(embedding_dim, max_seq_len, self._gen,
                               self._dev)

    def user_tower(self, batch):
        emb, mask = _masked_history(self._table(), batch["item_seq"],
                                    self._shard())
        u = lookup(self.emb_user, batch["user_id"].to(torch.int64))
        return u + self.hgn(emb, mask, u) + torch.sum(emb, dim=1)


class _SHANAttention(nn.Module):
    def __init__(self, dim, generator, device):
        super().__init__()
        self.proj = dense(dim, dim, generator, device)

    def forward(self, seq, mask, user_emb):
        key = F.relu(self.proj(seq))
        alpha = masked_softmax(torch.einsum("bld,bd->bl", key, user_emb),
                               mask)
        return torch.einsum("bl,bld->bd", alpha, seq)


class SHAN(SequentialRecommender):
    """Two-level attention with the user as query (`shan.py` shape):
    long-term over the whole history, then short-term over [long ; the
    last ``short_len`` items]."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, num_users: int = 0,
                 short_len: int = 5, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.short_len = short_len
        self.emb_user = item_table(num_users, embedding_dim, self._gen,
                                   self._dev, shard=True)
        self.long = _SHANAttention(embedding_dim, self._gen, self._dev)
        self.short = _SHANAttention(embedding_dim, self._gen, self._dev)

    def user_tower(self, batch):
        emb, mask = _masked_history(self._table(), batch["item_seq"],
                                    self._shard())
        u = lookup(self.emb_user, batch["user_id"].to(torch.int64))
        long = self.long(emb, mask, u)
        s = self.short_len
        cand = torch.cat([long[:, None], emb[:, -s:]], dim=1)
        cand_mask = torch.cat([torch.ones_like(mask[:, :1]), mask[:, -s:]],
                              dim=1)
        return self.short(cand, cand_mask, u)


class FOSSIL(SequentialRecommender):
    """user = Σ history / |H|^α + Σ_k η_k · e_{last−k}, η_k = global +
    per-user (`fossil.py` shape); the item bias through an augmented
    column."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, num_users: int = 0,
                 alpha: float = 0.5, order_k: int = 1, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.alpha, self.order_k = alpha, order_k
        dev = self._dev
        self.bias_item = nn.Parameter(torch.zeros(self.vocab_size, 1,
                                                  device=dev))
        self.eta_bias = nn.Parameter(torch.zeros(order_k, device=dev))
        self.emb_eta_user = item_table(num_users, order_k, self._gen, dev)

    def _table(self):
        return torch.cat([self.emb_item,
                          shard_slice(self.bias_item, self._shard())], dim=1)

    def user_tower(self, batch):
        emb, _ = _masked_history(self.emb_item, batch["item_seq"],
                                 self._shard())
        denom = torch.pow(torch.clamp(batch["seq_len"], min=1).to(emb.dtype),
                          self.alpha)[:, None]
        sim = torch.sum(emb, dim=1) / denom
        eta = self.eta_bias[None, :] \
            + self.emb_eta_user[batch["user_id"].to(torch.int64)]
        markov = torch.einsum("bk,bkd->bd", eta,
                              emb[:, -self.order_k:].flip(1))
        ones = torch.ones((sim.shape[0], 1), dtype=sim.dtype,
                          device=sim.device)
        return torch.cat([sim + markov, ones], dim=-1)


class HRM(SequentialRecommender):
    """Two-level pooling of [user ; pooled last-transaction items]
    (`hrm.py` shape), 'max' or 'avg' at each level."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, num_users: int = 0,
                 high_order: int = 2, pool_layer1: str = "max",
                 pool_layer2: str = "avg", dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.high_order = high_order
        self.pool_layer1, self.pool_layer2 = pool_layer1, pool_layer2
        self.emb_user = item_table(num_users, embedding_dim, self._gen,
                                   self._dev, shard=True)

    @staticmethod
    def _pool(x, mask, mode):
        m = mask[..., None].to(x.dtype)
        if mode == "max":
            return torch.amax(torch.where(m > 0, x, torch.full_like(x, -1e9)),
                              dim=1)
        return torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                     min=1e-12)

    def user_tower(self, batch):
        item_seq = batch["item_seq"][:, -self.high_order:].to(torch.int64)
        mask = item_seq != 0
        # the newest slot always counts (a short history's max pool)
        mask = torch.cat([mask[:, :-1], torch.ones_like(mask[:, -1:])], dim=1)
        l1 = self._pool(lookup(self._table(), item_seq, self._shard()), mask,
                        self.pool_layer1)
        u = lookup(self.emb_user, batch["user_id"].to(torch.int64))
        pair = torch.stack([u, l1], dim=1)
        return self._pool(pair, torch.ones(pair.shape[:2], dtype=torch.bool,
                                           device=pair.device),
                          self.pool_layer2)


class NPE(SequentialRecommender):
    """user = dropout(relu(u) + relu(Σ history)); items scored through a
    relu'd output table (`npe.py` shape)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, num_users: int = 0,
                 dropout: float = 0.2, compute_dtype: str = "float32",
                 temperature: float = 1.0, similarity: str = "dot",
                 right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        g, dev = self._gen, self._dev
        self.emb_item_out = item_table(self.vocab_size, embedding_dim, g, dev,
                                       shard=True)
        self.emb_user = item_table(num_users, embedding_dim, g, dev,
                                   shard=True)
        self.drop = Dropout(dropout)

    def _table(self):
        return F.relu(self.emb_item_out)

    def user_tower(self, batch):
        emb, _ = _masked_history(self.emb_item, batch["item_seq"],
                                 self._shard())
        u = lookup(self.emb_user, batch["user_id"].to(torch.int64))
        return self.drop(F.relu(u) + F.relu(torch.sum(emb, dim=1)))


# -- CORE ---------------------------------------------------------------------

class _COREEncoder(nn.Module):
    """Transformer-weighted mean of the history embeddings, so the session
    vector stays in the items' convex cone (`core.py` 'trm'); 'ave' is the
    plain mean."""

    def __init__(self, dim, max_seq_len, n_layers, n_heads, dropout, mode,
                 dtype, generator, device):
        super().__init__()
        self.mode = mode
        if mode != "ave":
            self.pos = PositionalEmbedding(max_seq_len, dim, generator,
                                           device)
            self.LayerNorm_0 = LayerNorm(dim, 1e-12, device=device)
            self.drop = Dropout(dropout)
            self.encoder = TransformerEncoder(
                dim, n_layers=n_layers, n_heads=n_heads,
                hidden_dropout=dropout, attn_dropout=dropout, causal=True,
                dtype=dtype, generator=generator, device=device)
            self.alpha = dense(dim, 1, generator, device)

    def forward(self, emb, mask):
        if self.mode == "ave":
            alpha = mask.to(emb.dtype)
        else:
            x = self.drop(self.LayerNorm_0(self.pos(emb)))
            x = self.encoder(x, mask)
            alpha = masked_softmax(self.alpha(x)[..., 0], mask)
        denom = torch.clamp(torch.sum(alpha, dim=1, keepdim=True), min=1e-12)
        return torch.einsum("bl,bld->bd", alpha / denom, emb)


class CORE(SequentialRecommender):
    """CORE (`core.py` shape): cosine scoring at temperature 0.07, the
    session vector a weighted mean of its item embeddings."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, n_layers: int = 2, n_heads: int = 2,
                 encoder_mode: str = "trm", dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 0.07,
                 similarity: str = "cosine", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.core = _COREEncoder(embedding_dim, max_seq_len, n_layers,
                                 n_heads, dropout, encoder_mode,
                                 self._enc_dtype(), self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.core(emb, mask)

    def full_scores(self, batch):
        def unit(x):
            return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                                   min=1e-12)
        shard = self._shard()
        if shard is not None:
            # the cosine normalises row by row: this rank's rows alone
            return sharded_logits(unit(self.user_tower(batch)),
                                  unit(self._table()), shard,
                                  self.vocab_size, self.temperature)
        return (unit(self.user_tower(batch)) @ unit(self._table()).T
                ) / self.temperature


# -- LightSANs ----------------------------------------------------------------

class _LightSANsLayer(nn.Module):
    def __init__(self, dim, n_heads, k_interests, dropout, generator,
                 device):
        super().__init__()
        g = generator
        self.n_heads, self.k_interests = n_heads, k_interests
        for name in ("q", "k", "v", "pq", "pk"):
            self.add_module(name, dense(dim, dim, g, device))
        self.theta = dense(dim, n_heads * k_interests, g, device)
        self.o = dense(dim, dim, g, device)
        self.LayerNorm_0 = LayerNorm(dim, 1e-12, device=device)
        self.ff1 = dense(dim, 4 * dim, g, device)
        self.ff2 = dense(4 * dim, dim, g, device)
        self.LayerNorm_1 = LayerNorm(dim, 1e-12, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x, pos, mask):
        b, length, d = x.shape
        h, dh = self.n_heads, d // self.n_heads

        def heads(name, t):
            return getattr(self, name)(t).reshape(b, length, h, dh)

        q, k, v = heads("q", x), heads("k", x), heads("v", x)
        # item-to-interest aggregation: softmax over L (the low-rank factor)
        theta = self.theta(x).reshape(b, length, h, self.k_interests)
        theta = masked_softmax(theta.permute(0, 3, 2, 1),      # (B, K, H, L)
                               mask[:, None, None, :])
        k_low = torch.einsum("bkhl,blhd->bkhd", theta, k)
        v_low = torch.einsum("bkhl,blhd->bkhd", theta, v)
        scale = math.sqrt(dh)
        attn = torch.softmax(torch.einsum("blhd,bkhd->bhlk", q, k_low)
                             / scale, dim=-1)
        ctx = torch.einsum("bhlk,bkhd->blhd", attn, v_low)
        # decoupled position attention, PAD keys masked
        pscores = torch.einsum("blhd,bmhd->bhlm", heads("pq", pos),
                               heads("pk", pos)) / scale
        pscores = torch.where(mask[:, None, None, :], pscores,
                              torch.full_like(pscores, -1e9))
        pctx = torch.einsum("bhlm,bmhd->blhd", torch.softmax(pscores, dim=-1),
                            v)
        out = self.drop(self.o((ctx + pctx).reshape(b, length, d)))
        x = self.LayerNorm_0(x + out)
        f = self.ff2(F.gelu(self.ff1(x), approximate="tanh"))
        return self.LayerNorm_1(x + self.drop(f))


class _LightSANsEncoder(nn.Module):
    def __init__(self, dim, max_seq_len, n_layers, n_heads, k_interests,
                 dropout, generator, device):
        super().__init__()
        self.n_layers = n_layers
        self.pos = nn.Parameter(0.02 * torch.randn(
            max_seq_len, dim, generator=generator, device=device))
        self.LayerNorm_0 = LayerNorm(dim, 1e-12, device=device)
        self.drop = Dropout(dropout)
        for i in range(n_layers):
            self.add_module(f"layer{i}", _LightSANsLayer(
                dim, n_heads, k_interests, dropout, generator, device))

    def forward(self, emb, mask):
        pos = self.pos[None, -emb.shape[1]:].expand(emb.shape)
        x = self.drop(self.LayerNorm_0(emb))
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, pos, mask)
        return x[:, -1, :]


class LightSANs(SequentialRecommender):
    """Low-rank decoupled self-attention (`lightsans.py` shape): attention
    through k latent interests plus a decoupled position attention."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, n_layers: int = 2, n_heads: int = 2,
                 k_interests: int = 5, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.lightsans = _LightSANsEncoder(
            embedding_dim, max_seq_len, n_layers, n_heads, k_interests,
            dropout, self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.lightsans(emb, mask)


# -- FDSA ---------------------------------------------------------------------

class _FDSAEncoder(nn.Module):
    def __init__(self, dim, max_seq_len, n_layers, n_heads, dropout, dtype,
                 generator, device):
        super().__init__()
        for j, name in enumerate(("item_trm", "feat_trm")):
            self.add_module(f"{name}_pos", PositionalEmbedding(
                max_seq_len, dim, generator, device))
            self.add_module(f"LayerNorm_{j}", LayerNorm(dim, 1e-12,
                                                        device=device))
            self.add_module(name, TransformerEncoder(
                dim, n_layers=n_layers, n_heads=n_heads,
                hidden_dropout=dropout, attn_dropout=dropout, causal=True,
                dtype=dtype, generator=generator, device=device))
        self.drop = Dropout(dropout)
        self.proj = dense(2 * dim, dim, generator, device)

    def _stream(self, j, name, x, mask):
        x = getattr(self, f"{name}_pos")(x)
        x = self.drop(getattr(self, f"LayerNorm_{j}")(x))
        return getattr(self, name)(x, mask)[:, -1, :]

    def forward(self, item_emb, feat_emb, mask):
        out = torch.cat([self._stream(0, "item_trm", item_emb, mask),
                         self._stream(1, "feat_trm", feat_emb, mask)], dim=-1)
        return self.proj(self.drop(out))


class FDSA(SequentialRecommender):
    """Dual self-attention over item ids and item features (`fdsa.py`
    shape)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, n_layers: int = 2, n_heads: int = 2,
                 feature_seq_name: str = "feat_seq", feature_vocab: int = 0,
                 dropout: float = 0.2, compute_dtype: str = "float32",
                 temperature: float = 1.0, similarity: str = "dot",
                 right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        g, dev = self._gen, self._dev
        self.feature_seq_name = feature_seq_name
        self.feature_vocab = feature_vocab
        if feature_vocab:
            self.emb_feat = item_table(feature_vocab, embedding_dim, g, dev,
                                       shard=True)
        else:
            self.feat_from_item = dense(embedding_dim, embedding_dim, g, dev)
        self.fdsa = _FDSAEncoder(embedding_dim, max_seq_len, n_layers,
                                 n_heads, dropout, self._enc_dtype(), g, dev)

    def user_tower(self, batch):
        emb, mask = _masked_history(self._table(), batch["item_seq"],
                                    self._shard())
        if self.feature_vocab:
            feat = lookup(self.emb_feat,
                              batch[self.feature_seq_name].to(torch.int64))
            feat = feat * mask[..., None].to(feat.dtype)
        else:
            feat = self.feat_from_item(emb)
        return self.fdsa(emb, feat, mask)


# -- RepeatNet ----------------------------------------------------------------

class _RepeatNetCore(nn.Module):
    def __init__(self, dim, hidden, dropout, vocab_size, generator, device):
        super().__init__()
        g = generator
        self.vocab_size = vocab_size
        self.drop = Dropout(dropout)
        self.GRUCell_0 = GRUCell(dim, hidden, g, device)
        for name in ("gate", "repeat", "explore"):
            self.add_module(f"{name}_u", dense(hidden, hidden, g, device))
            self.add_module(f"{name}_w", dense(hidden, hidden, g, device,
                                               bias=False))
            self.add_module(f"{name}_v", dense(hidden, 1, g, device,
                                               bias=False))
        self.gate_out = dense(2 * hidden, 2, g, device, bias=False)
        self.explore_out = dense(2 * hidden, vocab_size, g, device,
                                 bias=False)

    def forward(self, emb, item_seq, mask, seq_len):
        h = rnn(self.GRUCell_0, self.drop(emb))
        ht = _last_valid(h, seq_len)

        def attend(name):
            e = getattr(self, f"{name}_u")(h) \
                + getattr(self, f"{name}_w")(ht)[:, None]
            a = masked_softmax(getattr(self, f"{name}_v")(torch.tanh(e))
                               [..., 0], mask)
            return a, torch.einsum("bl,blh->bh", a, h)

        # the repeat-explore gate (`repeatnet.py` RepeatExploreMechanism)
        _, c_re = attend("gate")
        gate = torch.softmax(self.gate_out(torch.cat([ht, c_re], dim=-1)),
                             dim=-1)
        # repeat head: attention weights copied onto the history's ids
        a_rep, _ = attend("repeat")
        b = item_seq.shape[0]
        p_repeat = torch.zeros((b, self.vocab_size), dtype=a_rep.dtype,
                               device=a_rep.device).scatter_add(
            1, item_seq, a_rep * mask.to(a_rep.dtype))
        # explore head: softmax over the vocabulary, the history suppressed
        _, c_ex = attend("explore")
        logits = self.explore_out(torch.cat([ht, c_ex], dim=-1))
        seen = torch.zeros((b, self.vocab_size), dtype=torch.bool,
                           device=item_seq.device)
        seen[torch.arange(b, device=item_seq.device)[:, None], item_seq] = True
        seen[:, 0] = False
        p_explore = torch.softmax(torch.where(
            seen, torch.full_like(logits, -1e9), logits), dim=-1)
        return gate[:, :1] * p_repeat + gate[:, 1:] * p_explore


class RepeatNet(SequentialRecommender):
    """Repeat-aware session model (`repeatnet.py` shape). `full_scores`
    returns log-probabilities, already normalized, so
    `full_softmax_loss`'s log-softmax leaves them as they are."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, hidden_size: int = 64,
                 dropout: float = 0.2, compute_dtype: str = "float32",
                 temperature: float = 1.0, similarity: str = "dot",
                 right_align: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.core = _RepeatNetCore(embedding_dim, hidden_size, dropout,
                                   self.vocab_size, self._gen, self._dev)

    def _probs(self, batch):
        item_seq = right_align_to_left(batch["item_seq"].to(torch.int64),
                                       batch["seq_len"])
        emb, mask = _masked_history(self._table(), item_seq, self._shard())
        return self.core(emb, item_seq, mask, batch["seq_len"])

    def full_scores(self, batch):
        # whole (B, V) log-probabilities under a mesh too: the explore
        # head is a replicated Dense over V and the repeat head scatters
        # over the history, so the mixture reads the sharded table only
        # through the history's lookup (the exchange; `ROADMAP.md` Queue C
        # 60)
        return torch.log(self._probs(batch) + 1e-12)

    def user_tower(self, batch):
        raise NotImplementedError("RepeatNet scores via full_scores (copy "
                                  "mechanism has no single user vector)")

    def forward(self, batch):
        return torch.gather(self.full_scores(batch), 1,
                            batch["__item_ids__"].to(torch.int64))


# -- SINE ---------------------------------------------------------------------

class _SINEEncoder(nn.Module):
    def __init__(self, dim, prototype_num, interest_num, generator, device):
        super().__init__()
        g = generator
        self.interest_num = interest_num
        self.prototypes = nn.Parameter(0.02 * torch.randn(
            prototype_num, dim, generator=g, device=device))
        self.att0 = dense(dim, dim, g, device)
        self.att1 = dense(dim, 1, g, device)
        self.key = dense(dim, dim, g, device)
        self.agg = dense(dim, dim, g, device)

    def forward(self, emb, mask, seq_len):
        d = emb.shape[-1]
        pool = self.prototypes
        # the self-attentive virtual user vector z_u
        a = masked_softmax(self.att1(torch.tanh(self.att0(emb)))[..., 0], mask)
        z = torch.einsum("bl,bld->bd", a, emb)
        # sparse concept activation: the top-k prototypes a user
        topv, topi = torch.topk(z @ pool.T, self.interest_num, dim=-1)
        c = pool[topi] * torch.sigmoid(topv)[..., None]         # (B, K, D)
        # per-concept attention over the history
        key = torch.tanh(self.key(emb))
        att = masked_softmax(torch.einsum("bld,bkd->bkl", key, c)
                             / math.sqrt(d), mask[:, None, :])
        phi = torch.einsum("bkl,bld->bkd", att, emb)
        # interests weighted by the predicted next intent
        mean = torch.sum(emb * mask[..., None].to(emb.dtype), dim=1) \
            / torch.clamp(seq_len, min=1)[:, None].to(emb.dtype)
        hat = torch.tanh(self.agg(mean))
        e = torch.softmax(torch.einsum("bkd,bd->bk", phi, hat) / 0.1, dim=-1)
        return torch.einsum("bk,bkd->bd", e, phi)


class SINE(SequentialRecommender):
    """Sparse-interest network (`rechub/models/matching/sine.py`, recbole
    `sine.py` shape): k of L_c concept prototypes activated a user, an
    attention a concept, aggregated by the predicted next intent."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, prototype_num: int = 50,
                 interest_num: int = 4, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(**_seq_args(locals()))
        self.sine = _SINEEncoder(embedding_dim, prototype_num, interest_num,
                                 self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.sine(emb, mask, seq_len)
