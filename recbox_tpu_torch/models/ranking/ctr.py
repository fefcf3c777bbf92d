"""CTR ranking models: DeepFM over uniform-width field embeddings.

Counterpart of `recbox_tpu/models/ranking/ctr.py` `_FieldModel` (:49-87)
and `DeepFM` (:136-237), both paths: the stacked (B, F, D) path (:153-166)
and the feature-major (F, B, D) path (:168-237). Parameter names follow the
flax ones, so `interop.from_jax_params` moves a JAX DeepFM onto this one:
``linear`` / ``embedding`` (FeatureEmbedding), ``lr.bias`` and ``dnn``
(stacked), ``lr_bias``, ``dnn_w1`` (F, D, H), ``dnn_b1`` and ``dnn_rest``
(feature-major). The block fast path (`_feature_major_block_logit`) is not
ported: it serves the opt-in block protocol, measured slower on the TPU.
The rest of the CTR zoo is not ported yet (`ROADMAP.md`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.base import RankingModel
from recbox_tpu_torch.nn.core import (
    MLP, FactorizationMachine, LogisticRegression, get_activation,
    xavier_normal_,
)
from recbox_tpu_torch.nn.embedding import (
    FeatureEmbedding, _field_view, stack_embeddings,
)

__all__ = ["DeepFM"]


class _FieldModel(RankingModel):
    """Uniform-width field embeddings plus the dim-1 linear embeddings.

    ``compute_dtype='bfloat16'`` runs the embeddings and the MLP in bf16
    (parameters stay float32; the logits come back float32). The linear
    module computes in float32, as in the JAX package."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 16,
                 compute_dtype: Optional[str] = "float32",
                 emb_init_scheme: str = "normal",
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(feature_map)
        self._gen, self._dev = self.init_rng(generator, device)
        self.embedding_dim = embedding_dim
        self.compute_dtype = compute_dtype
        self.emb_init_scheme = emb_init_scheme
        self.dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                      else torch.float32)
        self.linear = FeatureEmbedding(feature_map, embedding_dim=1,
                                       name="linear", generator=self._gen,
                                       device=self._dev)
        self.embedding = FeatureEmbedding(
            feature_map, embedding_dim=embedding_dim,
            emb_init_scheme=emb_init_scheme, dtype=self.dtype,
            name="embedding", generator=self._gen, device=self._dev)


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
        if batch_norm:
            raise NotImplementedError(
                "DeepFM(batch_norm=True) needs MLP BatchNorm, not ported yet "
                "(ROADMAP.md)")
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
            self._act = get_activation(activation)
            self.dnn_rest = MLP(h0, self.hidden_units[1:],
                                activation=activation, output_dim=1,
                                dropout=dropout, dtype=self.dtype,
                                generator=g, device=dev)
        else:
            self.lr = LogisticRegression(device=dev)
            self.fm = FactorizationMachine()
            self.dnn = MLP(n_fields * d, self.hidden_units,
                           activation=activation, output_dim=1,
                           dropout=dropout, dtype=self.dtype, generator=g,
                           device=dev)

    def logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = self.feature_map.input_features
        lin = self.linear(batch)
        embs = self.embedding(batch)
        if self.feature_major_compute:
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
        h = self._act(h)
        if self.dropout > 0:
            h = F.dropout(h, self.dropout, training=self.training)
        deep = self.dnn_rest(h)
        return (first.float() + fm.float()
                + deep.reshape(-1).float()).reshape(-1)
