"""Retrieval serving: towers → queryable top-k index.

Counterpart of `recbox_tpu/retrieval/service.py` `RetrievalService`:

    svc = RetrievalService(model, corpus_arrays)       # encode corpus now
    scores, ids = svc.query({"user_id": uids}, k=100)
    svc.refresh_items(new_corpus_arrays)               # corpus swap
    svc.save("serving/v42")                            # durable snapshot
    svc = RetrievalService.load("serving/v42", model)  # no re-encode

The model is a `MatchingModel` whose parameters it carries (the port has no
separate variables tree); the service moves it to its device and serves in
eval mode. The encoded corpus stays on the device; `query` returns numpy
(scores f32, ids int32) like the JAX package. Multi-interest towers
returning (B, K, D) retrieve per interest, then merge by max score with
per-row dedup. `from_trainer` serves a trainer's model as it stands: its
parameters are the trained ones (`SparseEmbeddingTrainer` updates the
model's own tables in place, so nothing needs merging), and the service
puts the model in eval mode on the trainer's device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.data.loader import MASK_KEY, ArrayLoader
from recbox_tpu_torch.retrieval.index import BruteForceMIPS
from recbox_tpu_torch.utils import tracing

__all__ = ["RetrievalService"]

# counts of `RetrievalService.query` alone, not of the corpus encode: the
# queries, the query rows through the user tower (the loader's padding
# included), the rows returned, and the sites at which the host waited on
# a CUDA device (each synchronous copy of a batch to the card, each select
# of its real rows, each wait for the results on the host)
query_counts = tracing.register("service", {
    "queries": 0, "rows_encoded": 0, "rows_served": 0, "host_waits": 0})


def _merge_interests(s: np.ndarray, i: np.ndarray, t: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge (B, K*t) per-interest candidates: dedup per row keeping each
    item's max score, return the top-t by merged score."""
    order = np.argsort(-s, axis=1, kind="stable")
    s_d = np.take_along_axis(s, order, axis=1)
    i_d = np.take_along_axis(i, order, axis=1)
    B = s.shape[0]
    out_s = np.full((B, t), -np.inf, np.float32)
    out_i = np.full((B, t), -1, i.dtype)
    for r in range(B):
        # first occurrence in desc-score order == per-id max score
        _, first = np.unique(i_d[r], return_index=True)
        keep = np.sort(first)[:t]
        out_s[r, :len(keep)] = s_d[r, keep]
        out_i[r, :len(keep)] = i_d[r, keep]
    return out_s, out_i


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """``tensors`` as numpy arrays on the host. From the card each is copied
    asynchronously into a pinned buffer made for this call, then the stream
    is synchronized: PyTorch's caching host allocator hands the block out
    again only once the caller has dropped the array, whereas a buffer kept
    across calls would be overwritten by the next query under a result the
    caller still holds. A CPU tensor is returned as it is.

    The cost: the arrays are views of page-locked memory, so a caller that
    keeps its results holds that much pinned host memory (32 MB for 8192
    queries at k=500), and the allocator caches every freed block for later
    copies instead of returning it to the system. A caller that keeps many
    results (a sweep over every user, say) should copy them
    (``np.array(s)``): the block then goes back to the cache at once, and
    the next call reuses it."""
    with tracing.span("service::to_host"):
        if tensors[0].device.type != "cuda":
            return [t.cpu().numpy() for t in tensors]
        bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for buf, t in zip(bufs, tensors):
            buf.copy_(t, non_blocking=True)
        with tracing.span("service::wait"):
            torch.cuda.current_stream(tensors[0].device).synchronize()
        query_counts["host_waits"] += 1
        return [buf.numpy() for buf in bufs]


class RetrievalService:
    """Encode-once item index + tower-encoded query path.

    ``device`` defaults to the CUDA device (`recbox_tpu_torch.resolve_device`);
    extra keyword arguments go to `BruteForceMIPS` (e.g. quantize='int8').
    ``mesh`` (JAX `service.py:67`) shards the index over its 'model' axis
    and runs the service on the mesh's device; every rank then builds,
    queries and saves the service together, and only rank 0 writes.
    """

    def __init__(self, model: torch.nn.Module,
                 corpus_arrays: Optional[Dict[str, np.ndarray]] = None,
                 metric: str = "ip", method: str = "auto",
                 batch_size: int = 8192,
                 item_embs: Optional[Union[np.ndarray, torch.Tensor]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None, **index_kwargs):
        if (corpus_arrays is None) == (item_embs is None):
            raise ValueError(
                "pass exactly one of corpus_arrays (encode now) or "
                "item_embs (pre-encoded, e.g. RetrievalService.load)")
        self.mesh = mesh
        if mesh is not None:
            from recbox_tpu_torch.parallel.mesh import device_on_mesh
            self.device = device_on_mesh(mesh, device)
        else:
            self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.metric = metric
        self.method = method
        self.batch_size = batch_size
        self.index_kwargs = index_kwargs
        if corpus_arrays is not None:
            self.refresh_items(corpus_arrays)
        else:
            self._build_index(torch.as_tensor(item_embs))

    @classmethod
    def from_trainer(cls, trainer, corpus_arrays: Dict[str, np.ndarray],
                     **kwargs) -> "RetrievalService":
        """A service over ``trainer``'s model, the corpus encoded now, on
        the trainer's device unless ``device`` is given; ``method`` is
        "auto" unless given (the kernel gate of `BruteForceMIPS`); the index
        sharded over ``mesh`` only when one is given, as in JAX (a mesh
        trainer's sharded tables, its `FeatureEmbedding`'s and the model's
        own, encode through their exchange either way, so every rank calls
        it; with ``mesh`` the index keeps this rank's 'model' shard of the
        encoded corpus and B5 merges the shards' top-k)."""
        kwargs.setdefault("device", trainer.device)
        return cls(trainer.model, corpus_arrays, **kwargs)

    @torch.no_grad()
    def _encode(self, fn, arrays: Dict[str, np.ndarray],
                count: bool = False) -> torch.Tensor:
        """``fn`` over ``arrays`` in the loader's padded batches, the
        padding's rows dropped; ``count`` (a query) adds the rows and the
        host's waits to `query_counts`."""
        outs = []
        with tracing.span("service::encode"):
            batches = iter(ArrayLoader(arrays, batch_size=self.batch_size,
                                       shuffle=False))
            while True:
                with tracing.span("service::load"):
                    batch = next(batches, None)
                if batch is None:
                    break
                with tracing.span("service::to_device"):
                    batch = {k: torch.as_tensor(v, device=self.device)
                             for k, v in batch.items()}
                mask = batch.pop(MASK_KEY)
                with tracing.span("service::tower"):
                    emb = fn(batch)
                with tracing.span("service::select"):
                    outs.append(emb[mask.bool()])
                if count:
                    query_counts["rows_encoded"] += mask.shape[0]
                    if self.device.type == "cuda":
                        # each copy from pageable memory (the inputs and
                        # the mask) and the boolean select wait for the card
                        query_counts["host_waits"] += len(batch) + 2
            return torch.cat(outs, dim=0)

    # -- corpus lifecycle ------------------------------------------------------
    def refresh_items(self, corpus_arrays: Dict[str, np.ndarray]) -> None:
        """Re-encode the corpus and rebuild the index (item catalog swap)."""
        self._build_index(self._encode(self.model.encode_item, corpus_arrays))

    def _build_index(self, item_embs: torch.Tensor) -> None:
        self.item_embs = item_embs.to(self.device)
        self.index = BruteForceMIPS(self.item_embs, metric=self.metric,
                                    method=self.method, mesh=self.mesh,
                                    device=self.device, **self.index_kwargs)

    # -- persistence -----------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist the encoded corpus (item_embs.npy), the model's
        state_dict (model.pt) and the index config (service.json), each
        written to a temporary name and moved into place atomically. Reload
        with ``RetrievalService.load(path, model)``: the model definition is
        code, the caller supplies it. Under several processes every rank
        calls it (a mesh-sharded model's tables are gathered whole) and
        only rank 0 writes (JAX `service.py:131`)."""
        from recbox_tpu_torch.parallel.mesh import full_state_dict, rank
        state = full_state_dict(self.model)
        if rank() != 0:
            return
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "item_embs.tmp.npy")  # np.save appends .npy
        np.save(tmp, self.item_embs.cpu().numpy())
        os.replace(tmp, os.path.join(path, "item_embs.npy"))
        tmp = os.path.join(path, "model.pt.tmp")
        with open(tmp, "wb") as fh:
            torch.save({k: v.cpu() for k, v in state.items()}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(path, "model.pt"))
        cfg = {"metric": self.metric, "method": self.method,
               "batch_size": self.batch_size,
               "index_kwargs": self.index_kwargs}
        tmp = os.path.join(path, "service.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(cfg, fh)
        os.replace(tmp, os.path.join(path, "service.json"))

    @classmethod
    def load(cls, path: str, model: torch.nn.Module, mesh=None,
             device: Optional[Union[str, torch.device]] = None
             ) -> "RetrievalService":
        """Rebuild a saved service: the model's parameters from model.pt,
        the index straight from the persisted embeddings (no re-encode),
        sharded over ``mesh`` when one is given."""
        with open(os.path.join(path, "service.json")) as fh:
            cfg = json.load(fh)
        with open(os.path.join(path, "model.pt"), "rb") as fh:
            state = torch.load(fh, map_location="cpu", weights_only=True)
        model.load_state_dict(state)
        item_embs = np.load(os.path.join(path, "item_embs.npy"))
        return cls(model, metric=cfg["metric"], method=cfg["method"],
                   batch_size=cfg["batch_size"], item_embs=item_embs,
                   device=device, mesh=mesh, **cfg["index_kwargs"])

    @property
    def num_items(self) -> int:
        return self.item_embs.shape[0]

    # -- queries ---------------------------------------------------------------
    def query(self, user_arrays: Dict[str, np.ndarray], k: int = 100,
              exclude: Optional[Sequence[Sequence[int]]] = None,
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, item_ids) top-k per query row, shapes (Q, min(k, N)).

        ``exclude`` gives per-row item-id lists to filter out (seen items);
        filtering over-retrieves by the longest list. When a row's pool is
        exhausted, trailing slots pad with score -inf, id -1.
        """
        with tracing.span("service::query"):
            s, i = self._query(user_arrays, k, exclude)
        query_counts["queries"] += 1
        query_counts["rows_served"] += s.shape[0]
        return s, i

    def _query(self, user_arrays: Dict[str, np.ndarray], k: int,
               exclude: Optional[Sequence[Sequence[int]]]
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = self._encode(self.model.encode_user, user_arrays, count=True)
        k = min(k, self.num_items)
        extra = max((len(e) for e in exclude), default=0) \
            if exclude is not None else 0
        t = min(k + extra, self.num_items)
        if q.ndim == 3:  # (B, K, D) multi-interest: retrieve per interest
            B, K, D = q.shape
            s, i = _to_host(*self.index.search(q.reshape(B * K, D), topk=t))
            with tracing.span("service::merge_interests"):
                s, i = _merge_interests(s.reshape(B, -1), i.reshape(B, -1),
                                        t)
        else:
            s, i = _to_host(*self.index.search(q, topk=t))
        if exclude is None:
            return s[:, :k], i[:, :k]
        with tracing.span("service::exclude"):
            # vectorized seen-filter: pad banned lists, mask to -inf, re-rank
            banned = np.full((s.shape[0], max(extra, 1)), -1, dtype=np.int64)
            for r, e in enumerate(exclude):
                if len(e):
                    banned[r, :len(e)] = np.asarray(e, dtype=np.int64)
            bad = (i[:, :, None] == banned[:, None, :]).any(-1)
            s = np.where(bad, -np.inf, s).astype(np.float32)
            order = np.argsort(-s, axis=1, kind="stable")[:, :k]
            out_s = np.take_along_axis(s, order, axis=1)
            out_i = np.take_along_axis(i, order, axis=1)
            return out_s, np.where(np.isneginf(out_s), -1, out_i)
