"""Session-graph recommenders: SRGNN and GCSAN, and their adjacency.

Counterpart of `recbox_tpu/models/sequential/session_graph.py` (:36-174).
The graph is positional, built on the device at static shape as JAX
builds it: for a right-padded session,

    eq[p, q] = [item_p == item_q]                      (B, L, L)
    C[p, q]  = #{t : item_t == item_p ∧ item_{t+1} == item_q}
             = eq[:, :, :L−1] · step · eq[:, 1:, :]    one batched product

binarised, each edge divided by the successor's (predecessor's) positional
multiplicity and row-normalised, which equals recbole's unique-node
adjacency (`session_adjacency`). A gated graph network (`_GGNN`, flax's
``GRUCell`` named ``gru`` over [incoming ; outgoing] messages) propagates
the node states; SRGNN reads them out by additive attention
(`_AttentionReadout`), GCSAN through a causal transformer mixed with the
last node's state. Both right-align the history themselves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.sequential.models import (
    Device, SequentialRecommender, _last_valid, right_align_to_left,
)
from recbox_tpu_torch.nn.attention import TransformerEncoder, dense
from recbox_tpu_torch.nn.recurrent import GRUCell
from recbox_tpu_torch.parallel.mesh import lookup

__all__ = ["SRGNN", "GCSAN", "session_adjacency"]


def session_adjacency(item_seq: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_in, a_out), each (B, L, L) f32: the normalised in / out adjacency
    over the positions of a right-padded ``item_seq`` (PAD = 0 at the
    tail), as JAX computes it (:36-66)."""
    valid = item_seq != 0
    eq = (item_seq[:, :, None] == item_seq[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    eqf = eq.to(torch.float32)
    step = (valid[:, :-1] & valid[:, 1:]).to(torch.float32)
    c = torch.einsum("bpt,bt,btq->bpq", eqf[:, :, :-1], step, eqf[:, 1:, :])
    b = (c > 0).to(torch.float32)                   # binary unique-node adj
    mult = torch.clamp(torch.sum(eqf, dim=2), min=1.0)   # multiplicity
    w_out = b / mult[:, None, :]
    a_out = w_out / torch.clamp(torch.sum(w_out, dim=2, keepdim=True),
                                min=1.0)
    w_in = b / mult[:, :, None]
    a_in = (w_in / torch.clamp(torch.sum(w_in, dim=1, keepdim=True),
                               min=1.0)).transpose(1, 2)
    return a_in, a_out


class _GGNN(nn.Module):
    """Gated graph network over session positions (`srgnn.py` GNN)."""

    def __init__(self, dim: int, steps: int, generator, device):
        super().__init__()
        self.steps = steps
        self.gru = GRUCell(2 * dim, dim, generator, device)
        self.w_in = dense(dim, dim, generator, device)
        self.w_out = dense(dim, dim, generator, device)

    def forward(self, h, a_in, a_out):
        b, length, d = h.shape
        for _ in range(self.steps):
            m_in = torch.einsum("bpq,bqd->bpd", a_in, self.w_in(h))
            m_out = torch.einsum("bpq,bqd->bpd", a_out, self.w_out(h))
            a = torch.cat([m_in, m_out], dim=-1)
            h = self.gru(h.reshape(b * length, d),
                         a.reshape(b * length, 2 * d)).reshape(b, length, d)
        return h


class _AttentionReadout(nn.Module):
    """s = w3 · [attention-pooled states ; last state] (`srgnn.py`)."""

    def __init__(self, dim: int, generator, device):
        super().__init__()
        g = generator
        self.w1 = dense(dim, dim, g, device)
        self.w2 = dense(dim, dim, g, device, bias=False)
        self.v = dense(dim, 1, g, device, bias=False)
        self.w3 = dense(2 * dim, dim, g, device, bias=False)

    def forward(self, h, mask, seq_len):
        ht = _last_valid(h, seq_len)
        alpha = self.v(torch.sigmoid(self.w1(ht)[:, None] + self.w2(h))
                       )[..., 0] * mask.to(h.dtype)
        sg = torch.einsum("bl,bld->bd", alpha, h)
        return self.w3(torch.cat([sg, ht], dim=-1))


class _SessionGraphModel(SequentialRecommender):
    def _node_states(self, batch):
        seq = right_align_to_left(batch["item_seq"].to(torch.int64),
                                  batch["seq_len"])
        mask = seq != 0
        emb = lookup(self._table(), seq, self._shard()) \
            * mask[..., None].to(self.emb_item.dtype)
        a_in, a_out = session_adjacency(seq)
        return self.gnn(emb, a_in, a_out), mask


class SRGNN(_SessionGraphModel):
    """Session-graph GNN (`srgnn.py` shape): the GGNN over the session's
    transition graph, then an attention readout of the global session
    vector and the last item's state."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, steps: int = 1, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        self.gnn = _GGNN(embedding_dim, steps, self._gen, self._dev)
        self.readout = _AttentionReadout(embedding_dim, self._gen, self._dev)

    def user_tower(self, batch):
        h, mask = self._node_states(batch)
        return self.readout(h, mask, batch["seq_len"])


class GCSAN(_SessionGraphModel):
    """Graph-contextualised self-attention (`gcsan.py` shape): GGNN node
    states → causal transformer; user = weight · attention at the last
    item + (1 − weight) · its node state."""

    def __init__(self, feature_map: FeatureMap, embedding_dim: int = 64,
                 max_seq_len: int = 50, steps: int = 1, n_layers: int = 1,
                 n_heads: int = 1, weight: float = 0.6, dropout: float = 0.2,
                 compute_dtype: str = "float32", temperature: float = 1.0,
                 similarity: str = "dot", right_align: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__(feature_map, embedding_dim, max_seq_len, dropout,
                         compute_dtype, temperature, similarity, right_align,
                         generator, device)
        self.weight = weight
        self.gnn = _GGNN(embedding_dim, steps, self._gen, self._dev)
        self.trm = TransformerEncoder(
            embedding_dim, n_layers=n_layers, n_heads=n_heads,
            hidden_dropout=dropout, attn_dropout=dropout, causal=True,
            dtype=self._enc_dtype(), generator=self._gen, device=self._dev)

    def user_tower(self, batch):
        h, mask = self._node_states(batch)
        seq_len = batch["seq_len"]
        ht = _last_valid(h, seq_len)
        at = _last_valid(self.trm(h, mask), seq_len)
        return self.weight * at + (1.0 - self.weight) * ht
