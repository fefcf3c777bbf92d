"""Sequential (next-item) recommenders: the base, SASRec, GRU4Rec, NARM,
STAMP, Caser and NextItNet.

Counterpart of `recbox_tpu/models/sequential/models.py`
(`right_align_to_left` :40, `_last_valid` :48, `SequentialRecommender`
:54-135, the encoders and models :140-329). A model encodes the user's
left-padded item history (``item_seq`` (B, L), PAD = 0, ``seq_len`` (B,))
into one vector in item-embedding space and scores by dot product against
its scoring table (``_table()``: the item table, or a model's augmented
one). Training protocols: ``full_scores`` (B, V) logits with
`ops.losses.full_softmax_loss`, ``fused_ce_loss``, the same CE through
kernel B2 (`ops/fused_ce.py`) without the (B, V) logits, and the sampled
negatives of `MatchingModel.forward`.

Under a mesh the item table row-shards (`parallel.mesh.shard_rows`, JAX's
``nn.with_partitioning`` at :83): the history and the item tower read it
through the mesh's exchange (`parallel.mesh.lookup`), and ``full_scores``
gives `parallel.mesh.ShardedLogits`, this rank's columns of the global
batch's scores, whose CE `full_softmax_loss` takes vocabulary-parallel.

``right_align`` (GRU4Rec, NARM and the session models default to it)
turns the history right-padded before the encoder, as JAX's base does.
``compute_dtype='bfloat16'`` runs the transformer encoders (SASRec here;
BERT4Rec, CORE, FDSA and GCSAN) and the full-softmax logits product in
bf16 with f32 accumulation; the recurrent and convolutional encoders keep
f32, as in JAX.

Parameter names follow the flax tree (``emb_item``, ``sasrec.pos.pos_emb``,
``gru4rec.GRUCell_0.ir``, ``caser.hconv2``, ``nextitnet.conv_a0``, ...),
so `interop.from_jax_params` moves a JAX model onto its counterpart.
Caser's flax kernels are NHWC, (h, D, 1, n_h) and (L, 1, 1, n_v): here
`torch.nn.Conv2d` over the (B, 1, L, D) image, weights (n_h, 1, h, D) and
(n_v, 1, L, 1), and the vertical maps read back in flax's (D, n_v) order.
NextItNet's flax ``padding='CAUSAL'`` is a left pad of (k − 1)·dilation
before a `torch.nn.Conv1d`, and its LayerNorms take flax's ε of 1e-6.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import MatchingModel
from recbox_tpu_torch.nn.attention import (
    LayerNorm, PositionalEmbedding, TransformerEncoder, dense,
)
from recbox_tpu_torch.nn.core import _TRUNC_STD, Dropout
from recbox_tpu_torch.nn.recurrent import GRUCell, rnn
from recbox_tpu_torch.ops.fused_ce import fused_softmax_ce
from recbox_tpu_torch.parallel.mesh import (
    lookup, row_shard, shard_rows, sharded_logits,
)

__all__ = ["SequentialRecommender", "SASRec", "GRU4Rec", "NARM", "STAMP",
           "Caser", "NextItNet", "right_align_to_left"]

Device = Optional[Union[str, torch.device]]


def right_align_to_left(item_seq: torch.Tensor,
                        seq_len: torch.Tensor) -> torch.Tensor:
    """Left-padded [0..0, i1..ik] rows to right-padded [i1..ik, 0..0]."""
    length = item_seq.shape[1]
    shift = (length - seq_len.to(torch.int64))[:, None]
    idx = (torch.arange(length, device=item_seq.device)[None, :] + shift) \
        % length
    return torch.gather(item_seq, 1, idx)


def _masked_history(table: torch.Tensor, item_seq: torch.Tensor,
                    shard=None):
    """(emb (B, L, D) with PAD rows zeroed, mask (B, L)). The rows come by
    `F.embedding`, whose backward sums a repeated id's rows in parallel
    segments (indexing's accumulating `index_put_` adds them one after
    another: on a Zipf batch of 1024 x 50 ids, 14.7 of BERT4Rec's 25.2 ms
    replayed step on an H100, `PERF.md` §5); under a mesh (``shard``, the
    table's `RowShard`) by the mesh's exchange."""
    item_seq = item_seq.to(torch.int64)
    mask = item_seq != 0
    emb = lookup(table, item_seq, shard, embedding=True)
    return emb * mask[..., None].to(emb.dtype), mask


def _last_valid(h: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
    """h (B, L, H), right-padded → the hidden state at position seq_len−1."""
    idx = torch.clamp(seq_len.to(torch.int64) - 1, min=0)
    return h[torch.arange(h.shape[0], device=h.device), idx]


def _conv_init(conv: nn.Module, generator) -> None:
    """flax ``Conv``'s init: lecun-normal over fan_in = in × the receptive
    field, zero bias."""
    fan_in = conv.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        nn.init.zeros_(conv.bias)


def item_table(rows: int, dim: int, generator, device,
               shard: bool = False) -> nn.Parameter:
    """An item-side table drawn as `nn.embedding.emb_init`: normal(1e-4);
    ``shard`` marks it for row-sharding under a mesh (JAX's
    ``nn.with_partitioning(emb_init(), (('data', 'model'), None))``)."""
    p = nn.Parameter(1e-4 * torch.randn(rows, dim, generator=generator,
                                        device=device))
    return shard_rows(p) if shard else p


class SequentialRecommender(MatchingModel):
    """Base: owns the item table (normal(1e-4), ``emb_init``) over the
    FeatureMap's corpus_index vocabulary (ids >= 1; 0 = PAD); ``item_tower``
    is a lookup in the scoring table ``_table()``, so user vectors and
    table rows share one space.

    ``compute_dtype='bfloat16'`` runs the transformer encoders and the
    full-softmax logits product in bf16 with f32 accumulation; parameters
    and the loss stay f32. ``right_align`` right-pads the history before
    `encode`."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, similarity, temperature)
        self._gen, self._dev = self.init_rng(generator, device)
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.right_align = right_align
        self.vocab_size = feature_map[feature_map.corpus_index].vocab_size
        self.emb_item = item_table(self.vocab_size, embedding_dim,
                                   self._gen, self._dev, shard=True)

    @property
    def _cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    def _enc_dtype(self) -> Optional[torch.dtype]:
        """The transformer encoders' compute dtype: bf16 when asked, else
        None (f32)."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None

    def _table(self) -> torch.Tensor:
        """The scoring table (V, D'): the item table unless a model
        augments it; under a mesh this rank's rows of it."""
        return self.emb_item

    def _shard(self):
        """The scoring table's `RowShard` under a mesh (the item table's),
        else None."""
        return row_shard(self.emb_item)

    def encode(self, emb: torch.Tensor, mask: torch.Tensor,
               seq_len: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def encode_sequence(self, item_seq: torch.Tensor,
                        seq_len: torch.Tensor) -> torch.Tensor:
        item_seq = item_seq.to(torch.int64)
        if self.right_align:
            item_seq = right_align_to_left(item_seq, seq_len)
        emb, mask = _masked_history(self._table(), item_seq, self._shard())
        return self.encode(emb, mask, seq_len)

    def user_tower(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.encode_sequence(batch["item_seq"], batch["seq_len"])

    def item_tower(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return lookup(self._table(), batch[self.feature_map.corpus_index].to(
            torch.int64), self._shard())

    def full_scores(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, vocab) f32 scores over the item vocabulary, divided by the
        temperature. In bf16 compute the operands round to bf16 and the
        product is f32: on the CPU as f32 products of the rounded values,
        on the card a bf16 `torch.matmul` (JAX leaves this product to XLA)
        with its output in f32. Under a mesh, this rank's columns of the
        global batch's scores (`parallel.mesh.ShardedLogits`)."""
        user = self.user_tower(batch)
        shard = self._shard()
        if shard is not None:
            return sharded_logits(user, self._table(), shard,
                                  self.vocab_size, self.temperature,
                                  self._cdtype)
        u, t = user.to(self._cdtype), self._table().to(self._cdtype)
        if u.dtype == torch.bfloat16 and u.device.type == "cpu":
            u, t = u.float(), t.float()
        return (u @ t.T).float() / self.temperature

    def fused_ce_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Scalar CE over the full vocabulary without the (B, vocab) logits:
        kernel B2 (`ops.fused_ce.fused_softmax_ce`) on ``user /
        temperature``. Equals ``full_softmax_loss(full_scores(batch),
        batch[corpus_index])`` under bf16 compute. Train it with an identity
        loss: ``Trainer(model, lambda out, b: out, cfg,
        train_method='fused_ce_loss')``. A single-shard path: it raises
        under a mesh, as the trainer does."""
        if self._shard() is not None:
            raise ValueError("fused_ce_loss is a single-shard path and "
                             "cannot run on a row-sharded table")
        user = self.user_tower(batch)
        return fused_softmax_ce(user / self.temperature, self._table(),
                                batch[self.feature_map.corpus_index])


# -- encoders -----------------------------------------------------------------

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
                 right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        self.n_layers, self.n_heads = n_layers, n_heads
        self.sasrec = _SASRecEncoder(
            embedding_dim, max_seq_len, n_layers, n_heads, dropout,
            self._enc_dtype(), self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.sasrec(emb, mask)


class _GRU4RecEncoder(nn.Module):
    def __init__(self, dim: int, hidden: int, n_layers: int, dropout: float,
                 generator, device):
        super().__init__()
        self.n_layers = n_layers
        self.drop = Dropout(dropout)
        for i in range(n_layers):
            self.add_module(f"GRUCell_{i}", GRUCell(
                dim if i == 0 else hidden, hidden, generator, device))
        self.proj = dense(hidden, dim, generator, device)

    def forward(self, emb, seq_len):
        x = self.drop(emb)
        for i in range(self.n_layers):
            x = rnn(getattr(self, f"GRUCell_{i}"), x)
        return self.proj(_last_valid(x, seq_len))


class GRU4Rec(SequentialRecommender):
    """GRU session encoder (`gru4rec.py` shape): ``n_layers`` GRUs over the
    right-padded history, the last valid state projected to D."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, hidden_size: int = 128,
                 n_layers: int = 1, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        self.gru4rec = _GRU4RecEncoder(embedding_dim, hidden_size, n_layers,
                                       dropout, self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.gru4rec(emb, seq_len)


class _NARMEncoder(nn.Module):
    def __init__(self, dim: int, hidden: int, dropout: float, generator,
                 device):
        super().__init__()
        g = generator
        self.drop = Dropout(dropout)
        self.GRUCell_0 = GRUCell(dim, hidden, g, device)
        self.a1 = dense(hidden, hidden, g, device, bias=False)
        self.a2 = dense(hidden, hidden, g, device, bias=False)
        self.v = dense(hidden, 1, g, device, bias=False)
        self.b = dense(2 * hidden, dim, g, device, bias=False)

    def forward(self, emb, mask, seq_len):
        h = rnn(self.GRUCell_0, self.drop(emb))
        ht = _last_valid(h, seq_len)
        alpha = self.v(torch.sigmoid(self.a1(h) + self.a2(ht)[:, None, :])
                       )[..., 0]
        alpha = alpha * mask.to(alpha.dtype)
        local = torch.einsum("bl,blh->bh", alpha, h)
        return self.b(self.drop(torch.cat([ht, local], dim=-1)))


class NARM(SequentialRecommender):
    """Neural attentive session recommender (`narm.py` shape): the GRU's
    last state (global) beside an attention-pooled local representation."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, hidden_size: int = 128,
                 dropout: float = 0.2, compute_dtype: str = "float32",
                 temperature: float = 1.0, similarity: str = "dot",
                 right_align: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        self.narm = _NARMEncoder(embedding_dim, hidden_size, dropout,
                                 self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.narm(emb, mask, seq_len)


class _STAMPEncoder(nn.Module):
    def __init__(self, dim: int, generator, device):
        super().__init__()
        g = generator
        for name in ("w1", "w2", "w3", "w0"):
            self.add_module(name, dense(dim, 1 if name == "w0" else dim, g,
                                        device, bias=False))
        self.ba = nn.Parameter(torch.zeros(dim, device=device))
        self.mlp_a = dense(dim, dim, g, device)
        self.mlp_b = dense(dim, dim, g, device)

    def forward(self, emb, mask, seq_len):
        denom = torch.clamp(seq_len, min=1)[:, None].to(emb.dtype)
        ms = torch.sum(emb, dim=1) / denom                  # mean memory
        mt = emb[:, -1, :]                                  # last click
        alpha = self.w0(torch.sigmoid(
            self.w1(emb) + self.w2(mt)[:, None] + self.w3(ms)[:, None]
            + self.ba))[..., 0]
        alpha = alpha * mask.to(alpha.dtype)
        ma = torch.einsum("bl,bld->bd", alpha, emb) + ms
        return torch.tanh(self.mlp_a(ma)) * torch.tanh(self.mlp_b(mt))


class STAMP(SequentialRecommender):
    """Short-term attention/memory priority (`stamp.py` shape)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        self.stamp = _STAMPEncoder(embedding_dim, self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.stamp(emb, mask, seq_len)


class _CaserEncoder(nn.Module):
    def __init__(self, dim: int, length: int, n_h: int, n_v: int,
                 heights: Sequence[int], dropout: float, generator, device):
        super().__init__()
        self.heights = tuple(heights)
        for h in self.heights:
            conv = nn.Conv2d(1, n_h, (h, dim), device=device)
            _conv_init(conv, generator)
            self.add_module(f"hconv{h}", conv)
        self.vconv = nn.Conv2d(1, n_v, (length, 1), device=device)
        _conv_init(self.vconv, generator)
        self.drop = Dropout(dropout)
        self.fc = dense(n_h * len(self.heights) + n_v * dim, dim, generator,
                        device)

    def forward(self, emb):
        b = emb.shape[0]
        img = emb[:, None]                                  # (B, 1, L, D)
        outs = [torch.amax(F.relu(getattr(self, f"hconv{h}")(img))[..., 0],
                           dim=2) for h in self.heights]    # (B, n_h) each
        v = F.relu(self.vconv(img))                         # (B, n_v, 1, D)
        # flax's NHWC map is (B, 1, D, n_v): flatten D-major, n_v minor
        outs.append(v.permute(0, 2, 3, 1).reshape(b, -1))
        z = self.drop(torch.cat(outs, dim=-1))
        return F.relu(self.fc(z))


class Caser(SequentialRecommender):
    """Convolutional sequence embedding (`caser.py` shape): horizontal
    filters of each height max-pooled over time, a vertical filter over
    the whole history, a dense layer."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, n_h: int = 8, n_v: int = 4,
                 heights: Sequence[int] = (2, 3, 4), dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        self.caser = _CaserEncoder(embedding_dim, max_seq_len, n_h, n_v,
                                   heights, dropout, self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.caser(emb)


class _NextItNetEncoder(nn.Module):
    def __init__(self, dim: int, dilations: Sequence[int], kernel_size: int,
                 generator, device):
        super().__init__()
        self.dilations = tuple(dilations)
        self.kernel_size = kernel_size
        for i, d in enumerate(self.dilations):
            for part, dil in (("a", d), ("b", 2 * d)):
                self.add_module(f"ln_{part}{i}", LayerNorm(dim, 1e-6,
                                                           device=device))
                conv = nn.Conv1d(dim, dim, kernel_size, dilation=dil,
                                 device=device)
                _conv_init(conv, generator)
                self.add_module(f"conv_{part}{i}", conv)

    def _causal(self, name: str, r: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, name)
        pad = (self.kernel_size - 1) * conv.dilation[0]
        out = conv(F.pad(r.transpose(1, 2), (pad, 0)))
        return out.transpose(1, 2)

    def forward(self, emb):
        x = emb
        for i in range(len(self.dilations)):
            r = F.relu(getattr(self, f"ln_a{i}")(x))
            r = self._causal(f"conv_a{i}", r)
            r = F.relu(getattr(self, f"ln_b{i}")(r))
            x = x + self._causal(f"conv_b{i}", r)
        return x[:, -1, :]


class NextItNet(SequentialRecommender):
    """Dilated causal CNN (`nextitnet.py` shape): residual blocks of two
    causal convolutions at dilations d and 2d."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, dilations: Sequence[int] = (1, 2, 4),
                 kernel_size: int = 3, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        self.nextitnet = _NextItNetEncoder(embedding_dim, dilations,
                                           kernel_size, self._gen, self._dev)

    def encode(self, emb, mask, seq_len):
        return self.nextitnet(emb)
