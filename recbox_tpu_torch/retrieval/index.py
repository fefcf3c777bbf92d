"""Brute-force MIPS top-k index: the serving-side retrieval engine.

Counterpart of `recbox_tpu/retrieval/index.py`. ``search`` returns (scores
(Q, k) f32, ids (Q, k) int32) tensors on the index's device; slots beyond
the candidate pool are score -inf, id -1 (every engine).

Methods:
* ``'auto'`` (default) / ``'pallas'``: the fused MIPS top-k kernel
  (`ops/mips_fused_topk.py`) behind the JAX package's structural-recall gate
  (`index.py:395-407`) and its corpus:k gate. For a CUDA index that is the
  hand-written kernel; for a CPU index it is the kernel's plain PyTorch
  version, i.e. the JAX package's device route at small size, not its
  CPU XLA fallback (`index.py:465-477`). Past the gates, 'auto' falls to
  'segmented' (k >= 256) or 'approx' as in the JAX package.
* ``'approx'`` / ``'segmented'``: the JAX package serves these with
  `lax.approx_max_k`, which PyTorch lacks. Here both are an exact
  query-chunked `torch.topk` over the (bf16-rounded, when ``bf16``)
  scores; its recall of 1.0 meets any ``recall_target``.
* ``'exact'`` / ``'exact_sort'``: item-chunked scan with a running top-k
  merge (`chunked_topk`), truly exact.
* ``quantize='int8'``: per-row int8 corpus, served by the kernel's int8
  variant on the 'auto' / 'pallas' route.

Not yet ported (each raises NotImplementedError): ``'refined'`` (two-phase
rescore), the XLA int8 sweep `int8_mips_topk` (int8 with 'approx', or
'auto' past the gates) and the mesh-sharded search. They belong to the
retrieval slice that ports the candidate kernels (`ROADMAP.md`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk
from recbox_tpu_torch.ops.mips_topk import SEGMENT, quantize_int8

__all__ = ["BruteForceMIPS", "chunked_topk", "quantize_int8"]

ArrayLike = Union[np.ndarray, torch.Tensor]

_LATER = ("waits for the retrieval slice that ports the candidate kernels "
          "(ROADMAP.md)")


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def chunked_topk(queries: torch.Tensor, items: torch.Tensor, topk: int,
                 chunk_size: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via an item-chunked scan with a running merge (the
    exactness oracle, `index.py:202-240`)."""
    n = items.shape[0]
    best_s = torch.full((queries.shape[0], topk), float("-inf"),
                        dtype=torch.float32, device=queries.device)
    best_i = torch.zeros((queries.shape[0], topk), dtype=torch.int64,
                         device=queries.device)
    for start in range(0, n, chunk_size):
        s = queries @ items[start:start + chunk_size].T
        cs, ci = torch.topk(s, min(topk, s.shape[1]), dim=1)
        merged_s = torch.cat([best_s, cs], dim=1)
        merged_i = torch.cat([best_i, ci + start], dim=1)
        best_s, pos = torch.topk(merged_s, topk, dim=1)
        best_i = torch.gather(merged_i, 1, pos)
    return best_s, best_i.to(torch.int32)


def _exact_query_chunked(queries: torch.Tensor, items: torch.Tensor,
                         topk: int, query_chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of query-chunked full score rows (serves 'approx' and
    'segmented'; see the module docstring)."""
    out_s, out_i = [], []
    for q0 in range(0, queries.shape[0], query_chunk):
        s, i = torch.topk(queries[q0:q0 + query_chunk] @ items.T, topk, dim=1)
        out_s.append(s)
        out_i.append(i.to(torch.int32))
    return torch.cat(out_s), torch.cat(out_i)


class BruteForceMIPS:
    """MIPS top-k index over an (N, D) item matrix.

    Args mirror the JAX package's: metric 'ip' | 'cosine' (L2-normalized
    at build and search); method 'auto' | 'pallas' | 'approx' |
    'segmented' | 'exact' | 'exact_sort'; recall_target (the fused
    kernel's structural-recall gate); chunk_size (exact scan); query_chunk
    (query chunking of the exact-topk methods); bf16 (bf16 corpus and
    queries for the kernel and the approx methods); quantize None | 'int8';
    keep_f32 (keep the f32 corpus beside the int8 rows). ``device``
    defaults to the CUDA device (`recbox_tpu_torch.resolve_device`).
    """

    def __init__(self, item_embs: ArrayLike, metric: str = "ip",
                 mesh=None, method: str = "auto",
                 recall_target: float = 0.95, chunk_size: int = 8192,
                 query_chunk: int = 1024, bf16: bool = True,
                 quantize: Optional[str] = None,
                 keep_f32: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        items = torch.as_tensor(item_embs).to(device=self.device,
                                              dtype=torch.float32)
        if metric == "cosine":
            items = _l2_normalize(items)
        elif metric != "ip":
            raise NotImplementedError(f"metric={metric}")
        if mesh is not None:
            raise NotImplementedError(f"the mesh-sharded search {_LATER}")
        self.metric = metric
        self.method = "exact_sort" if method == "exact" else method
        if self.method == "refined":
            raise NotImplementedError(f"method='refined' {_LATER}")
        if self.method not in ("auto", "pallas", "approx", "segmented",
                               "exact_sort"):
            raise NotImplementedError(f"method={method!r}")
        self.recall_target = recall_target
        self.num_items, self.dim = items.shape
        self.chunk_size = chunk_size
        self.query_chunk = query_chunk
        self.bf16 = bf16
        if quantize not in (None, "int8"):
            raise NotImplementedError(f"quantize={quantize!r}")
        if quantize and self.method not in ("approx", "auto", "pallas"):
            # an 'exact' request must not be answered with quantized scores
            raise NotImplementedError(
                f"quantize='int8' supports method='auto'/'approx'/"
                f"'refined'/'pallas', got method={method!r}")
        if quantize and self.method == "approx":
            raise NotImplementedError(
                f"the XLA int8 sweep (int8_mips_topk, quantize='int8' with "
                f"method='approx') {_LATER}")
        self.quantize = quantize
        self.q_items = self.item_scale = None
        self.items = items
        if quantize == "int8":
            self.q_items, self.item_scale = quantize_int8(items)
            if not keep_f32:
                self.items = None
        # the kernel's bf16 corpus, cast once here rather than per search
        self._kernel_items = None
        if quantize is None and bf16 and self.method in ("auto", "pallas"):
            self._kernel_items = items.to(torch.bfloat16)

    def _pallas_recall_ok(self, topk: int) -> bool:
        """The kernel keeps <= 1 winner per 128-item segment, so its
        expected recall loss is ~k·SEGMENT/(2N); route to it only when that
        fits recall_target (`index.py:395-407`)."""
        return (self.num_items * 2.0 * (1.0 - self.recall_target)
                >= topk * float(SEGMENT))

    def _kernel_gate(self, topk: int) -> bool:
        return (self.method in ("auto", "pallas")
                and self.num_items > 16 * topk
                and self._pallas_recall_ok(topk))

    def search(self, queries: ArrayLike, topk: int = 500
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        queries = torch.as_tensor(queries).to(device=self.device,
                                              dtype=torch.float32)
        if self.metric == "cosine":
            queries = _l2_normalize(queries)
        topk = min(topk, self.num_items)
        if self.quantize == "int8":
            if not self._kernel_gate(topk):
                raise NotImplementedError(
                    f"int8 search at k={topk} over {self.num_items} items "
                    f"falls past the kernel's gates to the XLA int8 sweep, "
                    f"which {_LATER}")
            return mips_fused_topk(queries, self.q_items, topk,
                                   valid_items=self.num_items,
                                   row_scale=self.item_scale,
                                   query_tile=self.query_chunk)
        if self._kernel_gate(topk):
            items = self._kernel_items if self.bf16 else self.items
            return mips_fused_topk(queries, items, topk,
                                   valid_items=self.num_items,
                                   query_tile=self.query_chunk)
        if self.method == "exact_sort":
            return chunked_topk(queries, self.items, topk, self.chunk_size)
        if self.method in ("approx", "segmented", "pallas", "auto") \
                and self.num_items > 4 * topk:
            items = self.items
            if self.bf16:
                items = items.to(torch.bfloat16).to(torch.float32)
                queries = queries.to(torch.bfloat16).to(torch.float32)
            return _exact_query_chunked(queries, items, topk,
                                        self.query_chunk)
        return chunked_topk(queries, self.items, topk, self.chunk_size)
