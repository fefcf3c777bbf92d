"""Sharded columnar dataset IO + a streaming loader with prefetch.

Own copy of `recbox_tpu/data/shards.py` over the port's `MASK_KEY` and
`num_batches` (`data/loader.py`); the numpy calls are the JAX package's in
its order, so both packages give the same batches from one seed, and shard
directories written by either load in the other. The native backend is
`data/native_shards.py` over the port's own build of the C++ reader
(`retrieval/native.py`). Batches are numpy dicts: the trainer moves them
to its device.

A replacement for the reference's block-streaming H5 pipeline
(`recbox/ranking/pytorch/dataloaders/h5_block_dataloader.py:26-118` — a
DataLoader that iterates shuffled h5 blocks and chains their batch
iterators, and `recbox/datasets/data_utils.py:9-129` save_h5/load_h5 with a
`num_samples` attribute):

* shards are plain ``.npz`` parts (stored, never compressed: the native
  reader decodes only stored members) + a ``meta.json`` carrying
  num_samples / columns / dtypes (the h5 attribute equivalent);
* `ShardLoader` streams shuffled shards with a BACKGROUND prefetch thread
  (the reference blocks on h5 reads between blocks), carries remainder rows
  across shard boundaries so every yielded batch has the SAME static shape
  (one captured step graph serves the whole epoch), and pads+masks the
  final tail like `ArrayLoader`.

Datasets that fit in memory should use `ArrayLoader`; this loader is for
disk-resident datasets streamed shard-by-shard.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from recbox_tpu_torch.data.loader import MASK_KEY, num_batches

__all__ = ["save_shards", "load_shards", "shard_meta", "ShardLoader"]

_META = "meta.json"


def save_shards(path: str, arrays: Dict[str, np.ndarray],
                rows_per_shard: int = 262_144) -> List[str]:
    """Write a dict of equal-length arrays as npz parts + meta.json."""
    lengths = {k: len(v) for k, v in arrays.items()}
    if len(set(lengths.values())) != 1:
        raise ValueError(f"ragged columns: {lengths}")
    n = next(iter(lengths.values()))
    os.makedirs(path, exist_ok=True)
    for stale in _shard_files(path):  # never mix with a previous save
        os.remove(stale)
    files = []
    for i, start in enumerate(range(0, n, rows_per_shard)):
        part = {k: v[start:start + rows_per_shard] for k, v in arrays.items()}
        fname = os.path.join(path, f"part-{i:05d}.npz")
        np.savez(fname, **part)
        files.append(fname)
    with open(os.path.join(path, _META), "w") as f:
        json.dump({
            "num_samples": n,
            "rows_per_shard": rows_per_shard,
            "num_shards": len(files),
            "columns": {k: {"dtype": str(v.dtype),
                            "shape": list(v.shape[1:])}
                        for k, v in arrays.items()},
        }, f, indent=2)
    return files


def shard_meta(path: str) -> dict:
    with open(os.path.join(path, _META)) as f:
        return json.load(f)


def _shard_files(path: str) -> List[str]:
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.startswith("part-") and f.endswith(".npz"))


def load_shards(path: str) -> Dict[str, np.ndarray]:
    """Concatenate every shard back into one in-memory dict."""
    parts = [dict(np.load(f)) for f in _shard_files(path)]
    if not parts:
        raise FileNotFoundError(f"no part-*.npz under {path}")
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


class ShardLoader:
    """Streaming fixed-shape batches over on-disk npz shards.

    Args:
      path: shard directory written by `save_shards`.
      batch_size: static batch size (constant across shard boundaries).
      shuffle: shuffle the shard ORDER and rows within each shard per epoch
        (block-shuffle — the reference's semantics: blocks shuffled, rows
        shuffled inside the block; not a global permutation).
      drop_last: drop the epoch's final partial batch instead of
        padding + `__mask__`.
      prefetch: number of shards loaded ahead by the background thread.
      shard_index/num_shard_readers: static per-host partition of the shard
        list for multi-host input pipelines (host i reads shards
        i, i+N, ...).
    """

    def __init__(self, path: str, batch_size: int = 2048,
                 shuffle: bool = True, drop_last: bool = False,
                 seed: int = 2024, prefetch: int = 2,
                 shard_index: int = 0, num_shard_readers: int = 1,
                 reader_backend: str = "auto"):
        # reader_backend: 'auto' uses the native C++ decoder pool
        # (`native/shard_reader.cpp`) when librecbox_native.so is available,
        # else the numpy producer thread; 'native'/'numpy' force one.
        # Both deliver shards in the identical epoch order with identical
        # per-shard shuffle seeds — batches are bit-for-bit equal.
        if reader_backend not in ("auto", "native", "numpy"):
            raise ValueError(f"reader_backend={reader_backend!r}")
        self.reader_backend = reader_backend
        self.path = path
        self.files = _shard_files(path)[shard_index::num_shard_readers]
        if not self.files:
            raise FileNotFoundError(f"no part-*.npz under {path}")
        self.meta = shard_meta(path)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.epoch = 0
        if num_shard_readers == 1:
            self.n = int(self.meta["num_samples"])
        else:
            # per-reader row count from meta alone (every shard holds
            # rows_per_shard except the last) — no shard is opened here
            total = int(self.meta["num_samples"])
            rps = int(self.meta["rows_per_shard"])
            n_shards = int(self.meta["num_shards"])
            last_rows = total - (n_shards - 1) * rps

            def rows_of(global_idx: int) -> int:
                return last_rows if global_idx == n_shards - 1 else rps

            self.n = sum(rows_of(i) for i in
                         range(shard_index, n_shards, num_shard_readers))

    def __len__(self) -> int:
        return num_batches(self.n, self.batch_size, self.drop_last)

    @property
    def num_samples(self) -> int:
        return self.n

    def peek_batch(self) -> Dict[str, np.ndarray]:
        """First batch from the first shard, without starting the prefetch
        pipeline (Trainer.init shape tracing)."""
        part = dict(np.load(self.files[0]))
        bs = self.batch_size
        batch = {k: v[:bs] for k, v in part.items()}
        n = len(next(iter(batch.values())))
        if n < bs:
            batch = {k: np.concatenate([v, np.repeat(v[-1:], bs - n, axis=0)])
                     for k, v in batch.items()}
        batch[MASK_KEY] = np.ones(bs, dtype=np.float32)
        return batch

    def _producer(self, order: List[str], out: "queue.Queue",
                  seeds: List[int], stop: threading.Event) -> None:
        def put(item) -> bool:
            # bounded-queue put that aborts when the consumer abandons the
            # iterator (otherwise the thread blocks forever holding shards)
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for f, seed in zip(order, seeds):
                if stop.is_set():
                    return
                part = dict(np.load(f))
                if self.shuffle:
                    perm = np.random.default_rng(seed).permutation(
                        len(next(iter(part.values()))))
                    part = {k: v[perm] for k, v in part.items()}
                if not put(part):
                    return
            put(None)
        except BaseException as e:  # surface IO errors in the consumer
            put(e)

    def _resolve_backend(self) -> str:
        if self.reader_backend != "auto":
            return self.reader_backend
        from recbox_tpu_torch.data.native_shards import native_reader_available
        return "native" if native_reader_available() else "numpy"

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(self.files)
        if self.shuffle:
            self.rng.shuffle(order)
        seeds = [int(s) for s in
                 self.rng.integers(0, 2 ** 31, size=len(order))]
        self.epoch += 1
        backend = self._resolve_backend()
        if backend == "native":
            from recbox_tpu_torch.data.native_shards import NativeShardStream
            stream = NativeShardStream(order,
                                       prefetch=max(1, self.prefetch))

            def native_parts():
                # decode runs in the C++ pool; the per-shard row shuffle
                # uses the SAME seeds as the numpy producer
                for seed, part in zip(seeds, stream):
                    if self.shuffle:
                        perm = np.random.default_rng(seed).permutation(
                            len(next(iter(part.values()))))
                        part = {k: v[perm] for k, v in part.items()}
                    yield part
                yield None

            q = native_parts()
            get = lambda: next(q)
            stop = None
            t = None
        else:
            q = queue.Queue(maxsize=max(1, self.prefetch))
            stop = threading.Event()
            t = threading.Thread(target=self._producer,
                                 args=(order, q, seeds, stop), daemon=True)
            t.start()
            get = q.get

        bs = self.batch_size
        carry: Optional[Dict[str, np.ndarray]] = None
        try:
            while True:
                part = get()
                if isinstance(part, BaseException):
                    raise part
                if part is None:
                    break
                if carry is not None:
                    part = {k: np.concatenate([carry[k], part[k]])
                            for k in part}
                    carry = None
                n = len(next(iter(part.values())))
                full = (n // bs) * bs
                for start in range(0, full, bs):
                    batch = {k: v[start:start + bs] for k, v in part.items()}
                    batch[MASK_KEY] = np.ones(bs, dtype=np.float32)
                    yield batch
                if full < n:
                    carry = {k: v[full:] for k, v in part.items()}
            if carry is not None and not self.drop_last:
                n = len(next(iter(carry.values())))
                pad = bs - n
                batch = {k: np.concatenate(
                    [v, np.repeat(v[-1:], pad, axis=0)])
                    for k, v in carry.items()}
                mask = np.zeros(bs, dtype=np.float32)
                mask[:n] = 1.0
                batch[MASK_KEY] = mask
                yield batch
        finally:
            if t is not None:
                # unblocks the producer even when the consumer abandons the
                # iterator mid-epoch (Trainer's init peek or early stop)
                stop.set()
                t.join(timeout=5.0)
            else:
                stream.close()
