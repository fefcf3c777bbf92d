"""The extended CTR zoo: 19 models on `ctr.py`'s field machinery.

Counterpart of `recbox_tpu/models/ranking/ctr_extended.py`: field-aware
FMs (FFM, FwFM, FmFM, FEFM, DeepFEFM, ONN), convolutional interactions
(CCPM, FGCNN), grouped bi-interactions (FLEN), input-aware FMs (IFM,
DIFM), EDCN's bridge and regulation streams, MLR, FiGNN's field graph,
EulerNet's complex-space orders, DeepIM, HFM, and the aliases DCNMix
(DCNv2 with the low-rank mixture) and FNN (DNN). Every model maps a batch
to (B,) f32 logits, builds the ``linear`` module and its ``lr`` block only
where JAX's does (so `PackedEmbeddingTrainer` plans the same packs), and
names its parameters as the flax tree does: ``ffm_embedding`` (the F·D-wide
field-aware tables, E[:, i, f] = v_{i→f}), ``pair_weight``,
``pair_kernel``, ``_FEFMCore_0``, ``dnn``, ``conv<i>``, ``recombine<i>``,
``mf_weight``, ``fen`` / ``fen_bit`` / ``fen_vec`` / ``fen_vec_out``,
``bias``, ``reg_c<i>`` / ``reg_d<i>`` / ``cross<i>`` / ``deep<i>``,
``region`` / ``learner``, FiGNN's ``init_att`` ... ``mlp2``, EulerNet's
``mu`` / ``euler<i>`` / ``reg``, ``InteractionMachine_0``.

Convolutions: CCPM's flax ``Conv`` over the field axis (NLC, SAME) is a
`torch.nn.Conv1d` over (B·D, C, F) with the SAME padding written out
(⌊(w − 1)/2⌋ before, the rest after); its p-max pooling is `torch.topk`
(values sorted descending, as ``lax.top_k``). FGCNN's (w, 1) convolution
over (B, F, D, C) is a `torch.nn.Conv2d` over (B, C, F, D), its max pool
VALID. The flattening orders are flax's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.ranking.ctr import DNN, DCNv2, _dense, _FieldModel
from recbox_tpu_torch.models.sequential.models import _conv_init
from recbox_tpu_torch.nn.attention import LayerNorm
from recbox_tpu_torch.nn.core import (
    Dropout, FactorizationMachine, LogisticRegression, xavier_normal_,
)
from recbox_tpu_torch.nn.embedding import FeatureEmbedding, stack_embeddings
from recbox_tpu_torch.nn.interactions import (
    HolographicInteraction, InnerProduct, InteractingLayer,
    InteractionMachine, triu_pairs,
)
from recbox_tpu_torch.nn.recurrent import GRUCell

__all__ = ["FFM", "FwFM", "FmFM", "FEFM", "DeepFEFM", "ONN", "CCPM", "FGCNN",
           "FLEN", "IFM", "DIFM", "EDCN", "MLR", "FiGNN", "EulerNet",
           "DeepIM", "HFM", "DCNMix", "FNN"]

Device = Optional[Union[str, torch.device]]
Gen = Optional[torch.Generator]


def _xavier(shape, generator, device) -> nn.Parameter:
    t = torch.empty(shape, device=device)
    xavier_normal_(t, generator)
    return nn.Parameter(t)


def _n_pairs(n: int) -> int:
    return n * (n - 1) // 2


class _Base(_FieldModel):
    """`_FieldModel` with the ``lr`` block where the model has ``linear``
    and ``with_lr``."""

    def __init__(self, feature_map, embedding_dim, compute_dtype,
                 emb_init_scheme, generator, device, linear=True,
                 embed=True, with_lr=True):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=linear,
                         embed=embed)
        if linear and with_lr:
            self.lr = LogisticRegression(device=self._dev)

    def _first(self, batch) -> torch.Tensor:
        return self._first_order(batch).reshape(-1)

    def _field_aware(self, batch) -> torch.Tensor:
        """(B, F, F, D): E[:, i, f] = feature i's vector for field f."""
        x = stack_embeddings(self.ffm_embedding(batch),
                             self.feature_map.input_features)
        return x.reshape(x.shape[0], self.n_fields, self.n_fields,
                         self.embedding_dim)

    def _make_field_aware(self):
        self.ffm_embedding = FeatureEmbedding(
            self.feature_map, embedding_dim=self.n_fields * self.embedding_dim,
            dtype=self.dtype, name="ffm_embedding", generator=self._gen,
            device=self._dev)


class FFM(_Base):
    """Field-aware FM: Σ_{i<j} ⟨v_{i→f_j}, v_{j→f_i}⟩ + the first-order
    term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, embed=False)
        self._make_field_aware()

    def logits(self, batch) -> torch.Tensor:
        e = self._field_aware(batch)
        iu, ju = triu_pairs(e.shape[1], e.device)
        inter = torch.sum(e[:, iu, ju] * e[:, ju, iu], dim=(1, 2))
        return self._first(batch) + inter.float()


class FwFM(_Base):
    """Field-weighted FM: Σ_{i<j} r_ij ⟨v_i, v_j⟩ + the first-order
    term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        self.pair_weight = _xavier((_n_pairs(self.n_fields), 1), self._gen,
                                   self._dev)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        iu, ju = triu_pairs(field.shape[1], field.device)
        gram = torch.einsum("bfd,bgd->bfg", field, field)
        inter = torch.sum(gram[:, iu, ju] * self.pair_weight[None, :, 0]
                          .to(gram.dtype), dim=1)
        return self._first(batch) + inter.float()


class FmFM(_Base):
    """Field-matrix FM: Σ_{i<j} ⟨v_i M_ij, v_j⟩, a (D, D) kernel a
    pair."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        d = embedding_dim
        self.pair_kernel = _xavier((_n_pairs(self.n_fields), d, d),
                                   self._gen, self._dev)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        iu, ju = triu_pairs(field.shape[1], field.device)
        left = torch.einsum("bpd,pde->bpe", field[:, iu],
                            self.pair_kernel.to(field.dtype))
        inter = torch.sum(left * field[:, ju], dim=(1, 2))
        return self._first(batch) + inter.float()


class _FEFMCore(nn.Module):
    """s_ij = v_i (W_ij + W_ijᵀ) v_j → the (B, P) interaction vector."""

    def __init__(self, n_fields: int, dim: int, generator, device):
        super().__init__()
        self.pair_kernel = _xavier((_n_pairs(n_fields), dim, dim), generator,
                                   device)

    def forward(self, field: torch.Tensor) -> torch.Tensor:
        iu, ju = triu_pairs(field.shape[1], field.device)
        w = self.pair_kernel + self.pair_kernel.transpose(1, 2)
        left = torch.einsum("bpd,pde->bpe", field[:, iu], w.to(field.dtype))
        return torch.sum(left * field[:, ju], dim=-1)


class FEFM(_Base):
    """Field-embedded FM: the symmetric pair kernels' sum + the first-order
    term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        self._FEFMCore_0 = _FEFMCore(self.n_fields, embedding_dim,
                                     self._gen, self._dev)

    def logits(self, batch) -> torch.Tensor:
        s = self._FEFMCore_0(self._fields(batch))
        return self._first(batch) + torch.sum(s, dim=1).float()


class DeepFEFM(_Base):
    """FEFM + a tower over [flat embeddings ‖ interaction vector]."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 hidden_units: Sequence[int] = (256, 128, 64),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        f = self.n_fields
        self._FEFMCore_0 = _FEFMCore(f, embedding_dim, self._gen, self._dev)
        self.dnn = self._mlp(f * embedding_dim + _n_pairs(f), hidden_units,
                             output_dim=1, dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        s = self._FEFMCore_0(field)
        flat = field.reshape(field.shape[0], -1)
        deep = self.dnn(torch.cat([flat, s.to(flat.dtype)], dim=-1))
        return (self._first(batch) + torch.sum(s, dim=1).float()
                + deep.reshape(-1).float())


class ONN(_Base):
    """ONN / NFFM: the field-aware pair products beside the flat
    embeddings, into a tower, + the first-order term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 hidden_units: Sequence[int] = (400, 400),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        self._make_field_aware()
        self.dnn = self._mlp(self.embedding.out_dim + _n_pairs(self.n_fields),
                             hidden_units, output_dim=1, dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        e = self._field_aware(batch)
        iu, ju = triu_pairs(e.shape[1], e.device)
        prods = torch.sum(e[:, iu, ju] * e[:, ju, iu], dim=-1)
        flat = self._flat(batch)
        x = torch.cat([flat, prods.to(flat.dtype)], dim=-1)
        return self._first(batch) + self.dnn(x).reshape(-1).float()


def _same_pad(w: int) -> Tuple[int, int]:
    """flax's SAME padding of a width-w kernel at stride 1."""
    return (w - 1) // 2, (w - 1) - (w - 1) // 2


class CCPM(_Base):
    """Convolutions along the field axis, each followed by flexible p-max
    pooling, then a tower, + the first-order term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 conv_kernel_widths: Sequence[int] = (6, 5),
                 conv_filters: Sequence[int] = (4, 4),
                 hidden_units: Sequence[int] = (128,), dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        self.widths = tuple(conv_kernel_widths)
        n = len(conv_filters)
        length, channels, self.ks = self.n_fields, 1, []
        for i, (w, f) in enumerate(zip(self.widths, conv_filters)):
            conv = nn.Conv1d(channels, f, w, device=self._dev)
            _conv_init(conv, self._gen)
            self.add_module(f"conv{i}", conv)
            k = max(1, int((1 - (i + 1) / n) * length)) if i < n - 1 else 3
            k = min(k, length)
            self.ks.append(k)
            length, channels = k, f
        self.dnn = self._mlp(embedding_dim * length * channels, hidden_units,
                             output_dim=1, dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch).float()
        b, f, d = field.shape
        x = field.transpose(1, 2).reshape(b * d, 1, f)          # (N, C, L)
        for i, (w, k) in enumerate(zip(self.widths, self.ks)):
            x = torch.tanh(getattr(self, f"conv{i}")(F.pad(x, _same_pad(w))))
            x = torch.topk(x, k, dim=-1, sorted=True).values
        x = x.transpose(1, 2).reshape(b, -1)                    # flax's NLC
        return self._first(batch) + self.dnn(x).reshape(-1).float()


class FGCNN(_Base):
    """Feature generation by convolution: (w, 1) convolutions, max pooling
    and a recombination Dense make new fields; an inner-product network
    over [raw ‖ generated] fields, + the first-order term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 conv_filters: Sequence[int] = (6, 8),
                 conv_kernel_widths: Sequence[int] = (7, 7),
                 new_maps: Sequence[int] = (3, 3),
                 pooling_widths: Sequence[int] = (2, 2),
                 hidden_units: Sequence[int] = (128, 64),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        d = embedding_dim
        self.layers = tuple(zip(conv_filters, conv_kernel_widths, new_maps,
                                pooling_widths))
        height, channels, n_fields = self.n_fields, 1, self.n_fields
        for i, (f, w, m, p) in enumerate(self.layers):
            conv = nn.Conv2d(channels, f, (w, 1), device=self._dev)
            _conv_init(conv, self._gen)
            self.add_module(f"conv{i}", conv)
            height //= p
            self.add_module(f"recombine{i}", _dense(
                height * f * d, height * m * d, True, self._gen, self._dev))
            n_fields += height * m
            channels = f
        self.dnn = self._mlp(n_fields * d + _n_pairs(n_fields), hidden_units,
                             output_dim=1, dropout=dropout)
        self.inner = InnerProduct()

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        b, _, d = field.shape
        x = field.float()[:, None]                              # (B, C, F, D)
        new_fields = []
        for i, (f, w, m, p) in enumerate(self.layers):
            x = F.pad(x, (0, 0) + _same_pad(w))
            x = torch.tanh(getattr(self, f"conv{i}")(x))
            x = F.max_pool2d(x, (p, 1), (p, 1))
            height = x.shape[2]
            rec = getattr(self, f"recombine{i}")(
                x.permute(0, 2, 1, 3).reshape(b, -1))
            new_fields.append(torch.tanh(rec).reshape(b, height * m, d))
        all_fields = torch.cat([field.float()] + new_fields, dim=1)
        flat = all_fields.reshape(b, -1)
        x = torch.cat([flat, self.inner(all_fields).to(flat.dtype)], dim=-1)
        return self._first(batch) + self.dnn(x).reshape(-1).float()


class FLEN(_Base):
    """Fields grouped by their ``source``: weighted inter-group products
    (``mf_weight``), intra-group FM bi-interactions and a deep stream,
    under ``Dense_0``, + the first-order term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 hidden_units: Sequence[int] = (256, 128),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        feats = feature_map.input_features
        keys = []
        for f in feats:
            if f.source not in keys:
                keys.append(f.source)
        self.groups = tuple(tuple(i for i, f in enumerate(feats)
                                  if f.source == k) for k in keys)
        if len(self.groups) > 1:
            self.mf_weight = nn.Parameter(torch.ones(
                _n_pairs(len(self.groups)), 1, device=self._dev))
        self.dnn = self._mlp(self.n_fields * embedding_dim, hidden_units,
                             dropout=dropout)
        self.Dense_0 = _dense(2 * embedding_dim + self.dnn.out_dim, 1, True,
                              self._gen, self._dev, xavier=True)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        b = field.shape[0]
        g_sum, fm_parts = [], []
        for idx in self.groups:
            sub = field[:, list(idx)]
            g_sum.append(torch.sum(sub, dim=1))
            fm_parts.append(0.5 * (torch.square(torch.sum(sub, dim=1))
                                   - torch.sum(torch.square(sub), dim=1)))
        gs = torch.stack(g_sum, dim=1)
        if gs.shape[1] > 1:
            iu, ju = triu_pairs(gs.shape[1], gs.device)
            mf = torch.sum(gs[:, iu] * gs[:, ju]
                           * self.mf_weight[None].to(gs.dtype), dim=1)
        else:
            mf = torch.zeros_like(gs[:, 0])
        fm = sum(fm_parts)
        deep = self.dnn(field.reshape(b, -1))
        out = torch.cat([mf.to(deep.dtype), fm.to(deep.dtype), deep],
                        dim=-1).float()
        return (self._first_order(batch) + self.Dense_0(out)).reshape(-1)


def _fen_scaled_fm(field, m, lin_stack, bias):
    """IFM / DIFM's head: the first-order weights and the FM, each field
    rescaled by its importance m (B, F)."""
    first = torch.sum(lin_stack[..., 0] * m, dim=1) + bias
    fm = FactorizationMachine()(field * m[..., None].to(field.dtype))
    return first.reshape(-1) + fm.reshape(-1).float()


class IFM(_Base):
    """Input-aware FM: a factor-estimating tower (``fen``) gives each
    example's field importances, softmax × F, which rescale the
    first-order and FM terms (no ``lr`` block: a global ``bias``)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 fen_hidden_units: Sequence[int] = (64, 64),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, with_lr=False)
        f = self.n_fields
        self.fen = self._mlp(f * embedding_dim, fen_hidden_units,
                             output_dim=f, dropout=dropout)
        self.bias = nn.Parameter(torch.zeros(1, device=self._dev))

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        b, f, _ = field.shape
        m = torch.softmax(self.fen(field.reshape(b, -1)).float(), dim=-1) * f
        lin = stack_embeddings(self.linear(batch),
                               self.feature_map.input_features)
        return _fen_scaled_fm(field, m, lin, self.bias)


class DIFM(_Base):
    """Dual input-aware FM: a bit-wise tower (``fen_bit``) and a
    vector-wise self-attention (``fen_vec``, read by ``fen_vec_out``) sum
    to the field importances."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 fen_hidden_units: Sequence[int] = (64,), att_dim: int = 8,
                 num_heads: int = 2, dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, with_lr=False)
        f, g, dev = self.n_fields, self._gen, self._dev
        self.fen_bit = self._mlp(f * embedding_dim, fen_hidden_units,
                                 output_dim=f, dropout=dropout)
        self.fen_vec = InteractingLayer(embedding_dim, att_dim, num_heads,
                                        generator=g, device=dev)
        self.fen_vec_out = _dense(f * att_dim * num_heads, f, False, g, dev)
        self.bias = nn.Parameter(torch.zeros(1, device=dev))

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        b = field.shape[0]
        m_bit = self.fen_bit(field.reshape(b, -1))
        m_vec = self.fen_vec_out(self.fen_vec(field).reshape(b, -1))
        m = (m_bit + m_vec).float()
        lin = stack_embeddings(self.linear(batch),
                               self.feature_map.input_features)
        return _fen_scaled_fm(field, m, lin, self.bias)


class _Regulation(nn.Module):
    """EDCN's regulation: temperature-softmax field gates (``gate``, ones)
    → the gated fields flat."""

    def __init__(self, n_fields: int, tau: float, device):
        super().__init__()
        self.tau = tau
        self.gate = nn.Parameter(torch.ones(n_fields, 1, device=device))

    def forward(self, field: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(self.gate / self.tau, dim=0)
        return (field * w[None]).reshape(field.shape[0], -1)


class EDCN(_Base):
    """Enhanced DCN: cross and deep streams exchanging through a bridge
    (pointwise addition or Hadamard product), each re-gated by a
    regulation module a layer, + the first-order term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 num_layers: int = 3,
                 bridge_type: str = "pointwise_addition", tau: float = 1.0,
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        f, g, dev = self.n_fields, self._gen, self._dev
        dim = f * embedding_dim
        self.num_layers, self.bridge_type = num_layers, bridge_type
        for i in range(num_layers):
            self.add_module(f"reg_c{i}", _Regulation(f, tau, dev))
            self.add_module(f"reg_d{i}", _Regulation(f, tau, dev))
            self.add_module(f"cross{i}", _dense(dim, dim, True, g, dev,
                                                xavier=True))
            self.add_module(f"deep{i}", _dense(dim, dim, True, g, dev))
        self.Dense_0 = _dense(3 * dim, 1, True, g, dev, xavier=True)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch).float()
        b, f, d = field.shape
        x0 = field.reshape(b, -1)
        xc, xd = self.reg_c0(field), self.reg_d0(field)
        for i in range(self.num_layers):
            xc = x0 * getattr(self, f"cross{i}")(xc) + xc
            xd = F.relu(getattr(self, f"deep{i}")(xd))
            bridge = xc + xd if self.bridge_type == "pointwise_addition" \
                else xc * xd
            if i < self.num_layers - 1:
                bf = bridge.reshape(b, f, d)
                xc = getattr(self, f"reg_c{i + 1}")(bf)
                xd = getattr(self, f"reg_d{i + 1}")(bf)
        logit = self.Dense_0(torch.cat([xc, xd, bridge], dim=-1))
        return self._first(batch) + logit.reshape(-1)


class MLR(_Base):
    """Mixed logistic regression: p = Σ_m softmax(region)_m ·
    σ(learner)_m, clipped to [1e-7, 1 − 1e-7], returned as its logit."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 num_regions: int = 4,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        w = self.embedding.out_dim
        self.region = _dense(w, num_regions, True, self._gen, self._dev)
        self.learner = _dense(w, num_regions, True, self._gen, self._dev)

    def logits(self, batch) -> torch.Tensor:
        flat = self._flat(batch).float()
        p = torch.sum(torch.softmax(self.region(flat), dim=-1)
                      * torch.sigmoid(self.learner(flat)), dim=-1)
        p = torch.clamp(p, 1e-7, 1 - 1e-7)
        return torch.log(p / (1.0 - p))


class _FiGNNLayer(nn.Module):
    """One propagation step: a = A · wp(h), then the shared GRU cell with h
    as carry and a as input, plus the initial state."""

    def __init__(self, dim: int, generator, device):
        super().__init__()
        self.wp = _dense(dim, dim, True, generator, device)

    def forward(self, h, w_adj, h0, cell: GRUCell):
        a = torch.einsum("bfg,bgd->bfd", w_adj, self.wp(h))
        b, f, d = h.shape
        return cell(h.reshape(b * f, d), a.reshape(b * f, d)).reshape(
            b, f, d) + h0


class FiGNN(_Base):
    """Field-interaction GNN: self-attended field states (``init_att``,
    ``init_proj``) propagate ``gnn_steps`` times over a learned complete
    field graph (leaky-relu edge scores, the diagonal masked, a softmax
    over neighbours) through a GRU cell (``gru``); the readout weighs each
    field's score (``mlp1``) by an un-squashed ``mlp2`` over the flat
    state."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 gnn_steps: int = 2, att_dim: int = 16, num_heads: int = 2,
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        d, f, g, dev = embedding_dim, self.n_fields, self._gen, self._dev
        self.gnn_steps = gnn_steps
        head = d // num_heads
        self.init_att = InteractingLayer(d, head, num_heads, generator=g,
                                         device=dev)
        self.init_proj = _dense(head * num_heads, d, True, g, dev)
        self.att_src = _dense(d, 1, False, g, dev)
        self.att_dst = _dense(d, 1, False, g, dev)
        self.gru = GRUCell(d, d, g, dev)
        self.prop = _FiGNNLayer(d, g, dev)
        self.mlp1 = _dense(d, 1, False, g, dev)
        self.mlp2 = _dense(f * d, f, False, g, dev)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        b, f, d = field.shape
        h0 = self.init_proj(self.init_att(field))
        e = F.leaky_relu(self.att_src(h0) + self.att_dst(h0).transpose(1, 2),
                         0.2)
        eye = torch.eye(f, dtype=torch.bool, device=field.device)[None]
        w_adj = torch.softmax(torch.where(eye, torch.full_like(e, -1e9), e),
                              dim=-1)
        h = h0
        for _ in range(self.gnn_steps):
            h = self.prop(h, w_adj, h0, self.gru)
        score = self.mlp1(h)[..., 0]
        weight = self.mlp2(h.reshape(b, f * d))
        return torch.sum(score * weight, dim=1).float()


def _orders_init(shape, generator, device) -> torch.Tensor:
    """softmax(randn / 0.01, axis=0): near one-hot columns."""
    return torch.softmax(torch.randn(shape, generator=generator,
                                     device=device) / 0.01, dim=0)


class _EulerLayer(nn.Module):
    """One Euler interaction layer: the explicit stream mixes log-modulus
    and phase across fields by ``inter_orders`` with ``bias_lam`` /
    ``bias_theta`` inside the mix; the implicit one is one shared ``im``
    Dense over the real and imaginary parts, relu; the two add."""

    def __init__(self, in_fields: int, dim: int, out_fields: int,
                 apply_norm: bool, drop_ex: float, drop_im: float,
                 generator, device):
        super().__init__()
        self.out_fields = out_fields
        self.inter_orders = nn.Parameter(
            _orders_init((in_fields, out_fields), generator, device))
        self.bias_lam = nn.Parameter(0.01 * torch.randn(
            1, dim, out_fields, generator=generator, device=device))
        self.bias_theta = nn.Parameter(0.01 * torch.randn(
            1, dim, out_fields, generator=generator, device=device))
        self.im = nn.Linear(in_fields * dim, out_fields * dim, device=device)
        with torch.no_grad():
            self.im.weight.normal_(0.0, 0.1, generator=generator)
            self.im.bias.zero_()
        if apply_norm:
            self.norm_r = LayerNorm(dim, device=device, fast_variance=True)
            self.norm_p = LayerNorm(dim, device=device, fast_variance=True)
        self.apply_norm = apply_norm
        self.drop_ex, self.drop_im = Dropout(drop_ex), Dropout(drop_im)

    def forward(self, r, p):
        b, _, d = r.shape
        log_l = self.drop_ex(0.5 * torch.log(r * r + p * p + 1e-8))
        theta = self.drop_ex(torch.atan2(p, r))
        lam_o = torch.einsum("bfd,fg->bdg", log_l, self.inter_orders) \
            + self.bias_lam
        th_o = torch.einsum("bfd,fg->bdg", theta, self.inter_orders) \
            + self.bias_theta
        lam_o = torch.exp(lam_o).transpose(1, 2)
        th_o = th_o.transpose(1, 2)
        r_i = F.relu(self.im(self.drop_im(r).reshape(b, -1))).reshape(
            b, self.out_fields, d)
        p_i = F.relu(self.im(self.drop_im(p).reshape(b, -1))).reshape(
            b, self.out_fields, d)
        o_r = r_i + lam_o * torch.cos(th_o)
        o_p = p_i + lam_o * torch.sin(th_o)
        if self.apply_norm:
            o_r, o_p = self.norm_r(o_r), self.norm_p(o_p)
        return o_r, o_p


class EulerNet(_Base):
    """Adaptive-order interactions in complex space: the embedding is the
    phase and a learned per-field ``mu`` the modulus; ``euler<i>`` layers
    of ``order_layers`` output fields; one ``reg`` Dense reads the real and
    the imaginary parts, and the two logits add."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 order_layers: Sequence[int] = (16, 16),
                 apply_norm: bool = False, dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        d, g, dev = embedding_dim, self._gen, self._dev
        self.mu = nn.Parameter(torch.ones(1, self.n_fields, 1, device=dev))
        self.order_layers = tuple(order_layers)
        fin = self.n_fields
        for i, fout in enumerate(self.order_layers):
            self.add_module(f"euler{i}", _EulerLayer(
                fin, d, fout, apply_norm, dropout, dropout, g, dev))
            fin = fout
        self.reg = nn.Linear(fin * d, 1, device=dev)
        with torch.no_grad():
            self.reg.weight.normal_(0.0, 0.01, generator=g)
            self.reg.bias.zero_()

    def logits(self, batch) -> torch.Tensor:
        e = self._fields(batch).float()
        b = e.shape[0]
        r, p = self.mu * torch.cos(e), self.mu * torch.sin(e)
        for i in range(len(self.order_layers)):
            r, p = getattr(self, f"euler{i}")(r, p)
        return (self.reg(r.reshape(b, -1))
                + self.reg(p.reshape(b, -1))).reshape(-1)


class DeepIM(_Base):
    """The interaction machine (``InteractionMachine_0``) beside a deep
    tower."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 im_order: int = 3,
                 hidden_units: Sequence[int] = (256, 128),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        self.InteractionMachine_0 = InteractionMachine(
            embedding_dim, im_order, self._gen, self._dev)
        self.dnn = self._mlp(self.n_fields * embedding_dim, hidden_units,
                             output_dim=1, dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        im = self.InteractionMachine_0(field).reshape(-1)
        deep = self.dnn(field.reshape(field.shape[0], -1)).reshape(-1)
        return im.float() + deep.float()


class HFM(_Base):
    """Holographic FM: circular convolution / correlation of field pairs,
    summed, or under a tower (``deep``, HFM+), + the first-order term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 interaction_type: str = "circular_convolution",
                 deep: bool = False,
                 hidden_units: Sequence[int] = (256, 128),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        self.holo = HolographicInteraction(interaction_type)
        self.deep = deep
        if deep:
            self.dnn = self._mlp(_n_pairs(self.n_fields) * embedding_dim,
                                 hidden_units, output_dim=1, dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        inter = self.holo(field)
        if self.deep:
            out = self.dnn(inter)
        else:
            b, _, d = field.shape
            out = torch.sum(inter.reshape(b, -1, d), dim=(1, 2))[:, None]
        return (self._first_order(batch)
                + out.reshape(-1, 1).float()).reshape(-1)


class DCNMix(DCNv2):
    """DCN-Mix: DCNv2 with the low-rank mixture-of-experts cross network."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 num_cross_layers: int = 3,
                 hidden_units: Sequence[int] = (400, 400),
                 dropout: float = 0.0, model_structure: str = "parallel",
                 use_low_rank_mixture: bool = True, low_rank: int = 32,
                 num_experts: int = 4,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal", generator: Gen = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, num_cross_layers,
                         hidden_units, dropout, model_structure,
                         use_low_rank_mixture, low_rank, num_experts,
                         compute_dtype, emb_init_scheme, generator, device)


class FNN(DNN):
    """FNN: a deep tower over factorization embeddings (FM pretraining is
    an initialization, not an architecture)."""
