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
* ``'segmented'`` (and 'auto' at k >= 256 past the kernel's gate), where
  the corpus holds more than 16·k items: `segmented_mips_topk`, JAX's
  segment merge (`index.py:145-200`): the top ``seg_k`` of each of 8
  corpus segments, exactly, by kernel B5, then the exact top-k of the
  merged candidates by B5 again. Its recall is bounded by the per-segment
  budget, as JAX's is.
* ``'approx'`` (and 'segmented' on a smaller corpus): the JAX package
  serves it with `lax.approx_max_k`, which PyTorch lacks. Here it is an
  exact query-chunked `torch.topk` over the (bf16-rounded, when ``bf16``)
  scores (`approx_mips_topk`); its recall of 1.0 meets any
  ``recall_target``.
* ``'refined'``: over-retrieve 4·k by `approx_mips_topk` (bf16), then
  rescore those candidates exactly in f32 (`_two_phase_exact`); past the
  corpus:k gate, `chunked_topk`.
* ``'exact'`` / ``'exact_sort'``: item-chunked scan with a running top-k
  merge (`chunked_topk`), truly exact.
* ``quantize='int8'``: per-row int8 corpus, served by the fused kernel's
  int8 variant on the 'auto' / 'pallas' route, else by the int8 sweep
  `int8_mips_topk` ('approx', 'refined' with an exact f32 rescore, and
  'auto' past the kernel's gates), whose top-k is exact here as well.

The mesh-sharded search (``mesh=``, JAX `index.py:333-393`): the items
are padded with -inf rows to a multiple of the 'model' size and
row-sharded over 'model' (replicated over 'data'); every rank passes the
same queries. A search takes each shard's top-k by JAX's routing ('auto' /
'approx' where the shard holds more than 4·k rows: `approx_mips_topk`,
exact here; else the exact f32 top-k), offsets its ids by the shard,
all-gathers the (Q, k) scores and ids over 'model', and merges the k·shards
candidates exactly with B5 (`ops.bitonic_topk.pallas_bitonic_topk`: the
kernel on the card, its plain version on the CPU), ties in position order
as `lax.top_k`'s. A shard's top-k reads its real rows only, so a padding
row is never a candidate; exhausted slots are -inf / -1. ``quantize='int8'``
with a mesh raises NotImplementedError, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.ops.bitonic_topk import pallas_bitonic_topk
from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk
from recbox_tpu_torch.ops.mips_topk import SEGMENT, quantize_int8
from recbox_tpu_torch.utils import tracing

__all__ = ["BruteForceMIPS", "chunked_topk", "approx_mips_topk",
           "segmented_mips_topk", "int8_mips_topk", "quantize_int8"]

ArrayLike = Union[np.ndarray, torch.Tensor]


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


def _rescore_exact(queries: torch.Tensor, items_f32: torch.Tensor,
                   cand: torch.Tensor, topk: int, query_chunk: int = 1024
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 rescore of per-query candidate lists → (scores, ids): the
    shared tail of every two-phase ('refined') path (`index.py:59-68`),
    in query chunks so the (chunk, k1, D) gather stays small."""
    out_s, out_i = [], []
    for q0 in range(0, queries.shape[0], query_chunk):
        c = cand[q0:q0 + query_chunk].long()
        exact = torch.einsum("qd,qkd->qk", queries[q0:q0 + query_chunk],
                             items_f32[c])
        s, pos = torch.topk(exact, topk, dim=1)
        out_s.append(s)
        out_i.append(torch.gather(c, 1, pos).to(torch.int32))
    return torch.cat(out_s), torch.cat(out_i)


def int8_mips_topk(queries: torch.Tensor, q_items: torch.Tensor,
                   item_scale: torch.Tensor, topk: int,
                   query_chunk: int = 1024, recall_target: float = 0.95,
                   oversample: int = 0,
                   items_f32: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized MIPS (`index.py:71-116`): queries quantized per row, the
    exact s8 × s8 product rescaled to f32 (``s32 · item_scale ·
    query_scale``), then the top-k, per query chunk.

    The s8 × s8 sums are exact, as XLA's s32 ones: an f32 product of the
    int8 values while D·127² < 2^24 (every sum an integer below 2^24), else
    f64; on the card that needs ``torch.backends.cuda.matmul.allow_tf32 =
    False``. JAX takes `approx_max_k(recall_target)`; here it is an exact
    `torch.topk`, which meets any ``recall_target``. With ``oversample > 0``
    and ``items_f32``, the sweep over-retrieves ``oversample × topk``
    candidates and rescores them exactly in f32 (the 'refined' pattern)."""
    refine = bool(oversample) and items_f32 is not None
    k1 = min(oversample * topk, q_items.shape[0]) if refine else topk
    wide = q_items.shape[1] * 127 * 127 >= 2**24
    work = torch.float64 if wide else torch.float32
    rows = q_items.to(work)
    out_s, out_i = [], []
    for q0 in range(0, queries.shape[0], query_chunk):
        qq, qs = quantize_int8(queries[q0:q0 + query_chunk])
        s32 = (qq.to(work) @ rows.T).to(torch.float32)
        s = s32 * item_scale[None, :] * qs[:, None]
        s, i = torch.topk(s, k1, dim=1)
        out_s.append(s)
        out_i.append(i.to(torch.int32))
    s, i = torch.cat(out_s), torch.cat(out_i)
    if refine:
        return _rescore_exact(queries, items_f32, i, topk, query_chunk)
    return s, i


def approx_mips_topk(queries: torch.Tensor, items: torch.Tensor, topk: int,
                     query_chunk: int = 1024, recall_target: float = 0.95,
                     bf16: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-chunked MIPS top-k (`index.py:119-140`): with ``bf16``, both
    sides rounded to bf16 and multiplied in f32 (bf16 × bf16 products summed
    in f32, as XLA's preferred-f32 bf16 dot). JAX's `approx_max_k` is an
    exact `torch.topk` here, which meets any ``recall_target``."""
    if bf16:
        items = items.to(torch.bfloat16).to(torch.float32)
        queries = queries.to(torch.bfloat16).to(torch.float32)
    out_s, out_i = [], []
    for q0 in range(0, queries.shape[0], query_chunk):
        s, i = torch.topk(queries[q0:q0 + query_chunk] @ items.T, topk, dim=1)
        out_s.append(s)
        out_i.append(i.to(torch.int32))
    return torch.cat(out_s), torch.cat(out_i)


def segmented_mips_topk(queries: torch.Tensor, items: torch.Tensor,
                        topk: int, query_chunk: int = 1024,
                        n_segments: int = 8, seg_k: int = 0,
                        bf16: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's segment-merge top-k for large k (`index.py:145-200`): the
    corpus is split into ``n_segments`` blocks of rows, each query keeps
    the top ``seg_k`` of every block, and the top-k of those
    n_segments·seg_k candidates is returned. ``seg_k`` (0: ~1.5× the even
    split) and the padding (zero item rows scored -inf up to a multiple of
    ``n_segments``, zero queries up to a multiple of ``query_chunk``) are
    JAX's. Recall is bounded by the per-segment budget, as in JAX: a
    query whose top-k holds more than ``seg_k`` items of one block loses
    the rest; raise ``seg_k`` (or lower ``n_segments``) for headroom.

    Each query chunk's scores are a product of operands rounded to bf16
    (with ``bf16``) with f32 results, as XLA's preferred-f32 dot; both
    selections are exact (JAX's CPU `approx_max_k` is exact too): the
    per-block top ``seg_k`` is one launch of kernel B5 over the chunk's
    (chunk·n_segments, block) score rows, the merge a second with the
    candidates' ids. B5 runs its plain version on CPU tensors and takes
    any k <= C on the card (past 16384 candidates at k above 8192 in its
    global-memory mode), as JAX's `lax.top_k` does. Returns
    ((Q, k) f32 scores, (Q, k) int32 ids), ties by position."""
    q, d = queries.shape
    n = items.shape[0]
    if not seg_k:
        # ~1.5x the even split, and never fewer merged candidates than topk
        seg_k = max(topk // n_segments + topk // (2 * n_segments), 1,
                    -(-topk // n_segments))
    seg_k = max(seg_k, -(-topk // n_segments))
    pad_n = (-n) % n_segments
    if pad_n:
        items = torch.cat([items, items.new_zeros((pad_n, d))])
    seg_len = items.shape[0] // n_segments
    pad_q = (-q) % query_chunk
    if pad_q:
        queries = torch.cat([queries, queries.new_zeros((pad_q, d))])
    if bf16:
        items = items.to(torch.bfloat16).to(torch.float32)
        queries = queries.to(torch.bfloat16).to(torch.float32)
    seg_off = torch.arange(n_segments, dtype=torch.int32,
                           device=items.device)[None, :, None] * seg_len
    out_s, out_i = [], []
    for q0 in range(0, queries.shape[0], query_chunk):
        s = queries[q0:q0 + query_chunk] @ items.T
        if pad_n:
            s[:, n:] = float("-inf")
        c = s.shape[0]
        cs, ci = pallas_bitonic_topk(s.view(c * n_segments, seg_len), None,
                                     seg_k)
        ci = (ci.view(c, n_segments, seg_k) + seg_off).view(c, -1)
        ts, ti = pallas_bitonic_topk(cs.view(c, -1), ci, topk)
        out_s.append(ts)
        out_i.append(ti)
    return torch.cat(out_s)[:q], torch.cat(out_i)[:q]


def _two_phase_exact(queries: torch.Tensor, items: torch.Tensor, topk: int,
                     oversample: int = 4, query_chunk: int = 1024
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 over-retrieval of oversample·k + exact f32 rescore of the
    candidates (`index.py:243-251`)."""
    k1 = min(oversample * topk, items.shape[0])
    _, cand = approx_mips_topk(queries, items, k1, query_chunk=query_chunk,
                               recall_target=0.99, bf16=True)
    return _rescore_exact(queries, items, cand, topk, query_chunk)


class BruteForceMIPS:
    """MIPS top-k index over an (N, D) item matrix.

    Args mirror the JAX package's: metric 'ip' | 'cosine' (L2-normalized
    at build and search); mesh (the sharded search over 'model', on the
    mesh's device; ``device`` must then be None or that device);
    method 'auto' | 'pallas' | 'approx' | 'segmented' | 'refined' |
    'exact' | 'exact_sort'; recall_target (the fused kernel's
    structural-recall gate; the int8 'refined' sweep runs at
    max(recall_target, 0.99), as JAX's does); chunk_size (exact scan);
    query_chunk (query chunking of the sweeps); bf16 (bf16 corpus and
    queries for the kernel and the approx methods); quantize None | 'int8';
    keep_f32 (keep the f32 corpus beside the int8 rows: default only for
    'refined', which rescores with it, and ``keep_f32=False`` with an int8
    'refined' raises ValueError). ``device`` defaults to the CUDA device
    (`recbox_tpu_torch.resolve_device`).
    """

    def __init__(self, item_embs: ArrayLike, metric: str = "ip",
                 mesh=None, method: str = "auto",
                 recall_target: float = 0.95, chunk_size: int = 8192,
                 query_chunk: int = 1024, bf16: bool = True,
                 quantize: Optional[str] = None,
                 keep_f32: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if quantize and mesh is not None:
            raise NotImplementedError(
                "quantize='int8' is unsharded-only for now")
        if mesh is not None:
            from recbox_tpu_torch.parallel.mesh import device_on_mesh
            self.device = device_on_mesh(mesh, device)
        else:
            self.device = resolve_device(device)
        items = torch.as_tensor(item_embs).to(device=self.device,
                                              dtype=torch.float32)
        if metric == "cosine":
            items = _l2_normalize(items)
        elif metric != "ip":
            raise NotImplementedError(f"metric={metric}")
        self.mesh = mesh
        self.metric = metric
        self.method = "exact_sort" if method == "exact" else method
        if self.method not in ("auto", "pallas", "approx", "segmented",
                               "refined", "exact_sort"):
            raise NotImplementedError(f"method={method!r}")
        self.recall_target = recall_target
        self.num_items, self.dim = items.shape
        self.chunk_size = chunk_size
        self.query_chunk = query_chunk
        self.bf16 = bf16
        if quantize not in (None, "int8"):
            raise NotImplementedError(f"quantize={quantize!r}")
        if quantize and self.method not in ("approx", "refined", "auto",
                                            "pallas"):
            # an 'exact' request must not be answered with quantized scores
            raise NotImplementedError(
                f"quantize='int8' supports method='auto'/'approx'/"
                f"'refined'/'pallas', got method={method!r}")
        if quantize and self.method == "refined" and keep_f32 is False:
            raise ValueError(
                "method='refined' needs the f32 corpus for the exact "
                "rescore; keep_f32=False contradicts it")
        if keep_f32 is None:
            keep_f32 = self.method == "refined"
        self.quantize = quantize
        self.keep_f32 = keep_f32
        self.q_items = self.item_scale = None
        self.items = items
        if mesh is not None:
            from recbox_tpu_torch.parallel.mesh import (
                MODEL_AXIS, mesh_coords, mesh_shape,
            )
            n_shards = mesh_shape(mesh)[MODEL_AXIS]
            pad = (-self.num_items) % n_shards
            if pad:
                items = torch.cat([items, torch.full(
                    (pad, self.dim), float("-inf"), device=self.device)])
            self.shard_size = items.shape[0] // n_shards
            self.shard_index = mesh_coords(mesh)[1]
            lo = self.shard_index * self.shard_size
            # this rank's shard; its real rows are the first shard_valid
            self.items = items[lo:lo + self.shard_size].clone()
            self.shard_valid = max(0, min(self.shard_size,
                                          self.num_items - lo))
        if quantize == "int8":
            self.q_items, self.item_scale = quantize_int8(items)
            if not keep_f32:
                self.items = None
        # the kernel's bf16 corpus, cast once here rather than per search
        self._kernel_items = None
        if quantize is None and bf16 and mesh is None \
                and self.method in ("auto", "pallas"):
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

    def _route(self, topk: int) -> str:
        """The route a search for ``topk`` (at most `num_items`) takes, as
        its span names it (``index::<route>``): 'sharded' (the mesh's
        search), 'fused' (the fused kernel, bf16 / f32 or int8), 'int8' (the
        int8 sweep, rescored in f32 for 'refined'), 'exact_sort',
        'segmented', 'approx', 'refined' (bf16 over-retrieval, f32 rescore)
        or 'chunked' (the exact scan)."""
        if self.mesh is not None:
            return "sharded"
        if self.quantize == "int8":
            return "fused" if self.method != "refined" \
                and self._kernel_gate(topk) else "int8"
        if self._kernel_gate(topk):
            return "fused"
        if self.method == "exact_sort":
            return "exact_sort"
        if (self.method == "segmented"
                or (self.method == "auto" and topk >= 256)) \
                and self.num_items > 16 * topk:
            return "segmented"
        if self.method in ("approx", "segmented", "pallas", "auto") \
                and self.num_items > 4 * topk:
            return "approx"
        if self.method == "refined" and self.num_items > 8 * topk:
            return "refined"
        return "chunked"

    def search(self, queries: ArrayLike, topk: int = 500
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        topk = min(topk, self.num_items)
        route = self._route(topk)
        with tracing.span("index::" + route):
            queries = torch.as_tensor(queries).to(device=self.device,
                                                  dtype=torch.float32)
            if self.metric == "cosine":
                queries = _l2_normalize(queries)
            return self._search(route, queries, topk)

    def _search(self, route: str, queries: torch.Tensor, topk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if route == "sharded":
            return self._search_sharded(queries, topk)
        if route == "fused":
            if self.quantize == "int8":
                return mips_fused_topk(queries, self.q_items, topk,
                                       valid_items=self.num_items,
                                       row_scale=self.item_scale,
                                       query_tile=self.query_chunk)
            items = self._kernel_items if self.bf16 else self.items
            return mips_fused_topk(queries, items, topk,
                                   valid_items=self.num_items,
                                   query_tile=self.query_chunk)
        if route == "int8":
            # the refined sweep runs at >= 0.99, as `_two_phase_exact`
            refine = self.method == "refined"
            return int8_mips_topk(
                queries, self.q_items, self.item_scale, topk,
                query_chunk=self.query_chunk,
                recall_target=(max(self.recall_target, 0.99) if refine
                               else self.recall_target),
                oversample=4 if refine else 0,
                items_f32=self.items if refine else None)
        if route == "segmented":
            return segmented_mips_topk(queries, self.items, topk,
                                       query_chunk=self.query_chunk,
                                       bf16=self.bf16)
        if route == "approx":
            return approx_mips_topk(queries, self.items, topk,
                                    query_chunk=self.query_chunk,
                                    recall_target=self.recall_target,
                                    bf16=self.bf16)
        if route == "refined":
            return _two_phase_exact(queries, self.items, topk,
                                    query_chunk=self.query_chunk)
        return chunked_topk(queries, self.items, topk, self.chunk_size)

    def _search_sharded(self, queries: torch.Tensor, topk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX's `_build_sharded_search` (`index.py:348-393`): the shard's
        top-k, ids offset by the shard, the all-gather over 'model', and
        the exact merge of the k·shards candidates by B5."""
        from recbox_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather
        k = min(topk, self.shard_size)
        q = queries.shape[0]
        cs = torch.full((q, k), float("-inf"), device=self.device)
        ci = torch.full((q, k), self.num_items, dtype=torch.int32,
                        device=self.device)
        kk = min(k, self.shard_valid)
        if kk:
            real = self.items[:self.shard_valid]
            if self.method in ("approx", "auto") and self.shard_size > 4 * k:
                s, i = approx_mips_topk(queries, real, kk,
                                        query_chunk=self.query_chunk,
                                        recall_target=self.recall_target,
                                        bf16=self.bf16)
            else:
                s, i = chunked_topk(queries, real, kk, self.chunk_size)
            cs[:, :kk] = s
            ci[:, :kk] = i + self.shard_index * self.shard_size
        all_s = all_gather(cs, self.mesh, MODEL_AXIS, dim=1)
        all_i = all_gather(ci, self.mesh, MODEL_AXIS, dim=1)
        valid = (all_i >= 0) & (all_i < self.num_items)
        all_s = torch.where(valid, all_s, torch.full_like(all_s,
                                                          float("-inf")))
        ms, mi = pallas_bitonic_topk(all_s, all_i, topk)
        mi = torch.where(torch.isfinite(ms), mi, torch.full_like(mi, -1))
        return ms, mi
