"""CTR ranking model zoo: the 13 models of the JAX package's `ctr.py`.

Counterpart of `recbox_tpu/models/ranking/ctr.py` (:49-473): `_FieldModel`
(:49-87), LR, FM, DNN, WideDeep, DeepFM (both paths: the stacked (B, F, D)
one, :153-166, and the feature-major (F, B, D) one, :168-237), NFM, AFM,
DCN, DCNv2, xDeepFM, AutoInt, PNN and FiBiNET. Every model maps a batch
dict to (B,) float32 logits. Submodules carry the flax names (``linear`` /
``embedding`` (FeatureEmbedding), ``lr``, ``MLP_0``, ``Dense_<i>``,
``CrossNet_0``, ``CrossNetV2_0`` / ``CrossNetMix_0``,
``CompressedInteractionNet_0``, ``InteractingLayer_<i>``, ``SENET_0``,
``bilinear_raw`` / ``bilinear_se``; DeepFM's ``dnn``, ``lr_bias``,
``dnn_w1`` (F, D, H), ``dnn_b1``, ``dnn_bn1``, ``dnn_rest``), so
`interop.from_jax_params` moves a JAX model's params and batch_stats over.
A model builds the ``linear`` module only where JAX's has one (DNN, DCN,
DCNv2, AutoInt and PNN have none), so `PackedEmbeddingTrainer` plans the
same packs as JAX's. DeepFM's feature-major path reads the rows blocks of
`PackedEmbeddingTrainer(block_rows=True)` without stacking them
(`_feature_major_block_logit`, JAX :239-308).

Under ``compute_dtype='bfloat16'`` the embeddings and the MLPs run in
bf16; the layers that are flax ``Dense``s without ``dtype=`` (the crosses,
the heads of DCN / DCNv2 / AutoInt, the CIN, SENET, the bilinear products,
AFM's attention) compute in f32, as flax promotes bf16 inputs against f32
parameters, and the logits come back f32.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import CATEGORICAL, FeatureMap
from recbox_tpu_torch.models.base import RankingModel
from recbox_tpu_torch.nn.attention import lecun_normal_
from recbox_tpu_torch.nn.core import (
    MLP, BatchNorm, Dropout, FactorizationMachine, LogisticRegression,
    get_activation, xavier_normal_,
)
from recbox_tpu_torch.nn.embedding import (
    FeatureEmbedding, _field_view, concat_embeddings, rows_block_key,
    stack_embeddings,
)
from recbox_tpu_torch.nn.interactions import (
    SENET, BilinearInteraction, CompressedInteractionNet, CrossNet,
    CrossNetMix, CrossNetV2, InnerProduct, InteractingLayer, triu_pairs,
)

__all__ = ["LR", "FM", "DNN", "WideDeep", "DeepFM", "NFM", "AFM", "DCN",
           "DCNv2", "xDeepFM", "AutoInt", "PNN", "FiBiNET"]

Device = Optional[Union[str, torch.device]]


def _dense(d_in: int, d_out: int, bias: bool, generator, device,
           xavier: bool = False) -> nn.Linear:
    """A flax ``Dense``: xavier_normal where JAX names it, else
    lecun_normal; zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias, device=device)
    (xavier_normal_ if xavier else lecun_normal_)(lin.weight, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class _FieldModel(RankingModel):
    """Uniform-width field embeddings (``embedding``) and, where the model
    has a first-order term, the dim-1 ``linear`` embeddings and the ``lr``
    block over them.

    ``compute_dtype='bfloat16'`` runs the embeddings and the MLPs in bf16
    (parameters stay float32; the logits come back float32). The linear
    module computes in float32, as in the JAX package."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None, linear: bool = True,
                 embed: bool = True):
        super().__init__(feature_map)
        self._gen, self._dev = self.init_rng(generator, device)
        self.embedding_dim = embedding_dim
        self.compute_dtype = compute_dtype
        self.emb_init_scheme = emb_init_scheme
        self.dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                      else torch.float32)
        self.n_fields = len(feature_map.input_features)
        if linear:
            self.linear = FeatureEmbedding(feature_map, embedding_dim=1,
                                           name="linear", generator=self._gen,
                                           device=self._dev)
        if embed:
            self.embedding = FeatureEmbedding(
                feature_map, embedding_dim=embedding_dim,
                emb_init_scheme=emb_init_scheme, dtype=self.dtype,
                name="embedding", generator=self._gen, device=self._dev)

    def _mlp(self, in_dim: int, hidden_units, **kw) -> MLP:
        return MLP(in_dim, tuple(hidden_units), dtype=self.dtype,
                   generator=self._gen, device=self._dev, **kw)

    def _first_order(self, batch) -> torch.Tensor:
        """The ``lr`` block over the stacked (B, F, 1) dim-1 lookups →
        (B, 1) float32."""
        lin = self.linear(batch)
        return self.lr(stack_embeddings(
            lin, self.feature_map.input_features)).float()

    def _fields(self, batch) -> torch.Tensor:
        return stack_embeddings(self.embedding(batch),
                                self.feature_map.input_features)

    def _flat(self, batch) -> torch.Tensor:
        return concat_embeddings(self.embedding(batch),
                                 self.feature_map.input_features)


class LR(_FieldModel):
    """First-order term only (`deepctr`'s linear logit)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, embed=False)
        self.lr = LogisticRegression(device=self._dev)

    def logits(self, batch) -> torch.Tensor:
        return self._first_order(batch).reshape(-1)


class FM(_FieldModel):
    """First-order term + second-order factorization machine."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        self.lr = LogisticRegression(device=self._dev)
        self.fm = FactorizationMachine()

    def logits(self, batch) -> torch.Tensor:
        return (self._first_order(batch)
                + self.fm(self._fields(batch)).float()).reshape(-1)


class DNN(_FieldModel):
    """A deep tower over the concatenated embeddings (FNN's shape)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 hidden_units: Sequence[int] = (400, 400, 400),
                 activation: str = "relu", dropout: float = 0.0,
                 batch_norm: bool = False,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        self.MLP_0 = self._mlp(self.embedding.out_dim, hidden_units,
                               activation=activation, output_dim=1,
                               dropout=dropout, batch_norm=batch_norm)

    def logits(self, batch) -> torch.Tensor:
        return self.MLP_0(self._flat(batch)).float().reshape(-1)


class WideDeep(_FieldModel):
    """The first-order wide part + a deep tower (`deepctr/models/wdl.py`)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 hidden_units: Sequence[int] = (400, 400, 400),
                 activation: str = "relu", dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        self.MLP_0 = self._mlp(self.embedding.out_dim, hidden_units,
                               activation=activation, output_dim=1,
                               dropout=dropout)
        self.lr = LogisticRegression(device=self._dev)

    def logits(self, batch) -> torch.Tensor:
        deep = self.MLP_0(self._flat(batch)).float()
        return (self._first_order(batch) + deep).reshape(-1)


class DeepFM(_FieldModel):
    """First-order + FM + deep tower (`deepctr/models/deepfm.py:22`).

    ``feature_major_compute=True`` keeps the field activations as (F, B, D):
    the per-feature rows of a packed gather are adjacent row blocks, so the
    stack is a contiguous concat; FM reduces over axis 0 and the first DNN
    layer contracts the feature axis with einsum('fbd,fdh->bh') against a
    (F, D, H) kernel drawn at the flat (F·D, H) fan-in. Both paths compute
    the same function. F counts every input feature of the schema; a batch
    carries them all.
    """

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 hidden_units: Sequence[int] = (400, 400, 400),
                 activation: str = "relu", dropout: float = 0.0,
                 batch_norm: bool = False,
                 feature_major_compute: bool = False,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        self.hidden_units = tuple(hidden_units)
        self.activation = activation
        self.dropout = dropout
        self.feature_major_compute = feature_major_compute
        n_fields = len(feature_map.input_features)
        d, g, dev = embedding_dim, self._gen, self._dev
        if feature_major_compute:
            h0 = self.hidden_units[0]
            self.lr_bias = nn.Parameter(torch.zeros(1, device=dev))
            w1 = torch.empty(n_fields * d, h0, device=dev)
            xavier_normal_(w1, g)
            self.dnn_w1 = nn.Parameter(w1.reshape(n_fields, d, h0))
            self.dnn_b1 = nn.Parameter(torch.zeros(h0, device=dev))
            if batch_norm:
                self.dnn_bn1 = BatchNorm(h0, device=dev)
            self._act = get_activation(activation)
            self.dnn_drop = Dropout(dropout)
            self.dnn_rest = MLP(h0, self.hidden_units[1:],
                                activation=activation, output_dim=1,
                                dropout=dropout, batch_norm=batch_norm,
                                dtype=self.dtype, generator=g, device=dev)
        else:
            self.lr = LogisticRegression(device=dev)
            self.fm = FactorizationMachine()
            self.dnn = MLP(n_fields * d, self.hidden_units,
                           activation=activation, output_dim=1,
                           dropout=dropout, batch_norm=batch_norm,
                           dtype=self.dtype, generator=g, device=dev)

    def logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = self.feature_map.input_features
        lin = self.linear(batch)
        embs = self.embedding(batch)
        if self.feature_major_compute:
            cat_block = batch.get(rows_block_key(self.embedding.path))
            lin_block = batch.get(rows_block_key(self.linear.path))
            if cat_block is not None and lin_block is not None:
                return self._feature_major_block_logit(cat_block, lin_block,
                                                       lin, embs)
            return self._feature_major_logit(lin, embs)
        field = stack_embeddings(embs, feats)
        flat = field.reshape(field.shape[0], -1)
        first = self.lr(stack_embeddings(lin, feats))
        return (first.float() + self.fm(field).float()
                + self.dnn(flat).float()).reshape(-1)

    def _feature_major_logit(self, lin, embs) -> torch.Tensor:
        def pooled(emb_dict):
            return torch.stack([_field_view(emb_dict[s.name])
                                for s in self.feature_map.input_features
                                if s.name in emb_dict], dim=0)  # (F, B, D)

        x = pooled(embs)
        lx = pooled(lin)                                        # (F, B, 1)
        first = torch.sum(lx.float(), dim=(0, 2)) + self.lr_bias
        s = torch.sum(x, dim=0)
        fm = 0.5 * torch.sum(torch.square(s)
                             - torch.sum(torch.square(x), dim=0), dim=-1)
        h = torch.einsum("fbd,fdh->bh", x, self.dnn_w1.to(x.dtype)) \
            + self.dnn_b1.to(x.dtype)
        return self._feature_major_head(first, fm, h)

    def _feature_major_head(self, first, fm, h) -> torch.Tensor:
        """The first DNN layer's pre-activation ``h`` through its norm,
        activation, dropout and the rest of the tower, plus the first and
        second order."""
        if hasattr(self, "dnn_bn1"):
            h = self.dnn_bn1(h)
        h = self.dnn_drop(self._act(h))
        deep = self.dnn_rest(h)
        return (first.float() + fm.float()
                + deep.reshape(-1).float()).reshape(-1)

    def _feature_major_block_logit(self, cat_block, lin_block, lin, embs
                                   ) -> torch.Tensor:
        """The feature-major logit over the rows blocks: (Fc, B, D) of the
        categorical features in schema order and (Fc, B, 1) of their
        first-order weights. FM's 0.5 (sum² − sum of squares) and the first
        layer's einsum('fbd,fdh->bh') both split over a partition of the
        feature axis, so each maximal schema-order run of categorical or
        numeric features adds its part and the (F, B, D) stack is never
        built; the parameters are the stacked path's."""
        specs = [s for s in self.feature_map.input_features
                 if s.name in embs]
        parts, cat_i = [], 0                        # (F_run, B, D) pieces
        for is_cat, grp in itertools.groupby(
                specs, key=lambda s: s.type == CATEGORICAL):
            g = list(grp)
            if is_cat:
                parts.append(cat_block[cat_i:cat_i + len(g)].to(self.dtype))
                cat_i += len(g)
            else:
                parts.append(torch.stack([embs[s.name] for s in g], dim=0))
        if cat_i != cat_block.shape[0]:
            raise ValueError(
                f"rows block carries {cat_block.shape[0]} features but the "
                f"schema embeds {cat_i} categorical columns")
        # the categorical first-order weights are the dim-1 block; the
        # numeric ones come from the linear module
        first = torch.sum(lin_block.float(), dim=(0, 2)) + self.lr_bias
        for s in specs:
            if s.type != CATEGORICAL:
                first = first + lin[s.name].float().reshape(-1)
        s_sum = sum(torch.sum(p, dim=0) for p in parts)
        sq_sum = sum(torch.sum(torch.square(p), dim=0) for p in parts)
        fm = 0.5 * torch.sum(torch.square(s_sum) - sq_sum, dim=-1)
        h = self.dnn_b1.to(self.dtype)
        off = 0
        for p in parts:
            h = h + torch.einsum("fbd,fdh->bh", p, self.dnn_w1[
                off:off + p.shape[0]].to(p.dtype))
            off += p.shape[0]
        return self._feature_major_head(first, fm, h)


class NFM(_FieldModel):
    """Bi-interaction pooling 0.5 (sum² − sum of squares), kept as a (B, D)
    vector, under an MLP, plus the first-order term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 hidden_units: Sequence[int] = (128, 128),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        self.MLP_0 = self._mlp(embedding_dim, hidden_units, output_dim=1,
                               dropout=dropout)
        self.lr = LogisticRegression(device=self._dev)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        bi = 0.5 * (torch.square(torch.sum(field, dim=1))
                    - torch.sum(torch.square(field), dim=1))
        return (self._first_order(batch)
                + self.MLP_0(bi).float()).reshape(-1)


class AFM(_FieldModel):
    """Attention-weighted pairwise products: ``Dense_0`` (D → attention_dim,
    relu) and ``Dense_1`` (→ 1, no bias) score each pair, a softmax over
    pairs pools them, ``Dense_2`` (no bias) reads the pool."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 attention_dim: int = 16, dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        g, dev, d = self._gen, self._dev, embedding_dim
        self.Dense_0 = _dense(d, attention_dim, True, g, dev)
        self.Dense_1 = _dense(attention_dim, 1, False, g, dev)
        self.att_drop = Dropout(dropout)
        self.Dense_2 = _dense(d, 1, False, g, dev)
        self.lr = LogisticRegression(device=dev)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        iu, ju = triu_pairs(field.shape[1], field.device)
        prod = (field[:, iu] * field[:, ju]).float()         # (B, P, D)
        att = self.Dense_1(F.relu(self.Dense_0(prod)))
        att = self.att_drop(torch.softmax(att, dim=1))
        pooled = torch.sum(att * prod, dim=1)
        return (self._first_order(batch) + self.Dense_2(pooled)).reshape(-1)


class DCN(_FieldModel):
    """CrossNet beside a deep tower over the flat embeddings, then
    ``Dense_0`` (xavier_normal) over their concat."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 num_cross_layers: int = 3,
                 hidden_units: Sequence[int] = (400, 400),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        g, dev, d = self._gen, self._dev, self.embedding.out_dim
        self.CrossNet_0 = CrossNet(d, num_cross_layers, g, dev)
        self.MLP_0 = self._mlp(d, hidden_units, dropout=dropout)
        self.Dense_0 = _dense(d + self.MLP_0.out_dim, 1, True, g, dev,
                              xavier=True)

    def logits(self, batch) -> torch.Tensor:
        x = self._flat(batch)
        out = torch.cat([self.CrossNet_0(x), self.MLP_0(x).float()], dim=-1)
        return self.Dense_0(out).reshape(-1)


class DCNv2(_FieldModel):
    """CrossNetV2 (or CrossNetMix with ``use_low_rank_mixture``) and a deep
    tower, ``model_structure`` 'parallel' (concat), 'stacked' (the tower
    over the crosses) or 'crossnet_only', then ``Dense_0``."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 num_cross_layers: int = 3,
                 hidden_units: Sequence[int] = (400, 400),
                 dropout: float = 0.0, model_structure: str = "parallel",
                 use_low_rank_mixture: bool = False, low_rank: int = 32,
                 num_experts: int = 4,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        if model_structure not in ("parallel", "stacked", "crossnet_only"):
            raise ValueError(f"model_structure={model_structure!r}")
        self.model_structure = model_structure
        g, dev, d = self._gen, self._dev, self.embedding.out_dim
        if use_low_rank_mixture:
            self.CrossNetMix_0 = CrossNetMix(d, num_cross_layers, low_rank,
                                             num_experts, g, dev)
        else:
            self.CrossNetV2_0 = CrossNetV2(d, num_cross_layers, g, dev)
        self._cross = "CrossNetMix_0" if use_low_rank_mixture \
            else "CrossNetV2_0"
        head = d
        if model_structure != "crossnet_only":
            self.MLP_0 = self._mlp(d, hidden_units, dropout=dropout)
            head = self.MLP_0.out_dim + (d if model_structure == "parallel"
                                         else 0)
        self.Dense_0 = _dense(head, 1, True, g, dev, xavier=True)

    def logits(self, batch) -> torch.Tensor:
        x = self._flat(batch)
        cross = getattr(self, self._cross)(x)
        if self.model_structure == "crossnet_only":
            out = cross
        elif self.model_structure == "stacked":
            out = self.MLP_0(cross).float()
        else:
            out = torch.cat([cross, self.MLP_0(x).float()], dim=-1)
        return self.Dense_0(out).reshape(-1)


class xDeepFM(_FieldModel):
    """CIN + the first-order term + a deep tower. ``cin_activation``
    'identity' (recbox's CIN) or 'relu' (recbole's)."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 cin_layer_sizes: Sequence[int] = (16, 16),
                 hidden_units: Sequence[int] = (400, 400),
                 dropout: float = 0.0, cin_activation: str = "identity",
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        g, dev = self._gen, self._dev
        self.CompressedInteractionNet_0 = CompressedInteractionNet(
            self.n_fields, cin_layer_sizes, cin_activation, g, dev)
        self.MLP_0 = self._mlp(self.n_fields * embedding_dim, hidden_units,
                               output_dim=1, dropout=dropout)
        self.lr = LogisticRegression(device=dev)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        flat = field.reshape(field.shape[0], -1)
        return (self._first_order(batch)
                + self.CompressedInteractionNet_0(field)
                + self.MLP_0(flat).float()).reshape(-1)


class AutoInt(_FieldModel):
    """Stacked self-attention over fields (``InteractingLayer_<i>``), then
    ``Dense_0`` over the flat result; with ``hidden_units`` a deep tower
    (``MLP_0``) over the flat embeddings is added."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 num_attention_layers: int = 3, attention_dim: int = 16,
                 num_heads: int = 2, hidden_units: Sequence[int] = (),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        g, dev = self._gen, self._dev
        self.num_attention_layers = num_attention_layers
        d = embedding_dim
        for i in range(num_attention_layers):
            self.add_module(f"InteractingLayer_{i}", InteractingLayer(
                d, attention_dim, num_heads, generator=g, device=dev))
            d = attention_dim * num_heads
        self.Dense_0 = _dense(self.n_fields * d, 1, True, g, dev,
                              xavier=True)
        if hidden_units:
            self.MLP_0 = self._mlp(self.n_fields * embedding_dim,
                                   hidden_units, output_dim=1,
                                   dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        x = field
        for i in range(self.num_attention_layers):
            x = getattr(self, f"InteractingLayer_{i}")(x)
        logit = self.Dense_0(x.reshape(x.shape[0], -1))
        if hasattr(self, "MLP_0"):
            logit = logit + self.MLP_0(
                field.reshape(field.shape[0], -1)).float()
        return logit.reshape(-1)


class PNN(_FieldModel):
    """Inner-product network: the flat embeddings beside every pairwise
    field product, under an MLP."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 hidden_units: Sequence[int] = (400, 400),
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device, linear=False)
        f = self.n_fields
        self.inner = InnerProduct()
        self.MLP_0 = self._mlp(f * embedding_dim + f * (f - 1) // 2,
                               hidden_units, output_dim=1, dropout=dropout)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        x = torch.cat([field.reshape(field.shape[0], -1), self.inner(field)],
                      dim=-1)
        return self.MLP_0(x).float().reshape(-1)


class FiBiNET(_FieldModel):
    """SENET-reweighted fields; bilinear pairs of the raw fields
    (``bilinear_raw``) and of the reweighted ones (``bilinear_se``) under an
    MLP, plus the first-order term."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 hidden_units: Sequence[int] = (400, 400),
                 reduction_ratio: int = 3,
                 bilinear_type: str = "field_interaction",
                 dropout: float = 0.0,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, compute_dtype,
                         emb_init_scheme, generator, device)
        g, dev, f, d = self._gen, self._dev, self.n_fields, embedding_dim
        self.SENET_0 = SENET(f, reduction_ratio, g, dev)
        self.bilinear_raw = BilinearInteraction(f, d, bilinear_type, g, dev)
        self.bilinear_se = BilinearInteraction(f, d, bilinear_type, g, dev)
        self.MLP_0 = self._mlp(f * (f - 1) * d, hidden_units, output_dim=1,
                               dropout=dropout)
        self.lr = LogisticRegression(device=dev)

    def logits(self, batch) -> torch.Tensor:
        field = self._fields(batch)
        x = torch.cat([self.bilinear_raw(field),
                       self.bilinear_se(self.SENET_0(field))], dim=-1)
        return (self._first_order(batch)
                + self.MLP_0(x).float()).reshape(-1)
