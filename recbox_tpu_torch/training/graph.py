"""K train steps from one CUDA graph of the step, replayed over staged batches.

The port's counterpart of `Trainer.train_steps_fused`'s one dispatch for K
steps (`recbox_tpu/training/trainer.py:262-304`, a `lax.scan` of the step):
the host overhead of an eager step (hundreds of kernel launches) is paid
once, at capture, and each later step is one `CUDAGraph.replay`.

Layout. The graph reads its batch from static device buffers of shape
(capacity, B, ...) a key, at a device cursor, and writes its loss into a
static (capacity,) buffer at the same cursor, then advances the cursor. A
call stages its K batches into the buffers (one copy a key, from pinned
memory or from the card), sets the cursor to 0 and replays K times: no
host work between replays. Parameters, optimizer state and the packs are
updated in place by the captured kernels, so every other path (an eager
step, `_restore_best`, `load`) must write them in place too.

What the capture must not bake in:
  - the optimizers keep their step count and learning rate in device
    tensors (`trainer._Optimizer`), read and advanced by the graph;
  - dropout draws from the trainer's generator, registered with the graph
    (`register_generator_state`), so each replay draws new bits;
  - a value passed by value to a kernel, such as kernel B1's embedding
    learning rate, is part of the trainer's ``_graph_token()``: the step is
    captured again when the token changes (the packed trainer's plateau);
  - the kernels count launches in Python, once at capture: the counts of
    the capture are taken back and added again at each replay.

A failed capture or replay raises; nothing falls back to eager steps. The
first `WARMUP_STEPS` steps of a trainer run the same step body eagerly on
a side stream, as a whole-network capture requires (lazy initialisation of
cuBLAS, the autograd engine and the kernels' caches).
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping

import numpy as np
import torch

__all__ = ["StepGraph", "WARMUP_STEPS", "kernel_counters"]

WARMUP_STEPS = 2


def kernel_counters() -> List[Dict[str, int]]:
    """The launch counts of every kernel wrapper of the port."""
    from recbox_tpu_torch.ops import (
        bitonic_topk, embedding_gather, fused_ce, mips_fused_topk, mips_topk,
        packed_delta,
    )
    return [m.launches for m in (bitonic_topk, embedding_gather, fused_ce,
                                 mips_fused_topk, mips_topk, packed_delta)]


def _signature(batches: Mapping) -> tuple:
    return tuple((k, tuple(v.shape[1:]), str(v.dtype))
                 for k, v in sorted(batches.items()))


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(v))


class StepGraph:
    """The static buffers and the captured step of one trainer, for one
    batch signature (keys, per-step shapes, dtypes) and ``capacity`` steps
    a call."""

    def __init__(self, trainer, batches: Mapping, capacity: int):
        dev = trainer.device
        self.trainer = trainer
        self.signature = _signature(batches)
        self.capacity = capacity
        self.inputs = {k: torch.empty((capacity,) + tuple(v.shape[1:]),
                                      dtype=_as_tensor(v[:1]).dtype,
                                      device=dev)
                       for k, v in batches.items()}
        self.losses = torch.zeros(capacity, dtype=torch.float32, device=dev)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graph = None
        self.token = None
        self.captured_launches: List[Dict[str, int]] = []
        self.capture_seconds = 0.0

    def fits(self, batches: Mapping, k: int) -> bool:
        return _signature(batches) == self.signature and k <= self.capacity

    def _body(self) -> None:
        """One step on the batch at the cursor; the captured function."""
        batch = {k: buf.index_select(0, self.cursor).squeeze(0)
                 for k, buf in self.inputs.items()}
        loss = self.trainer._train_step(batch)
        self.losses.index_copy_(0, self.cursor,
                                loss.reshape(1).to(torch.float32))
        self.cursor.add_(1)

    def _stage(self, batches: Mapping, k: int) -> None:
        for name, v in batches.items():
            src = _as_tensor(v)
            if src.device.type == "cpu":
                src = src.pin_memory()
            self.inputs[name][:k].copy_(src, non_blocking=True)
        self.cursor.zero_()

    def _capture(self, token) -> None:
        counters = kernel_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        gen = self.trainer.dropout_generator
        if gen is not None:
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            self._body()
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t0
        # nothing ran during the capture: its counts go back, and each
        # replay adds them
        self.captured_launches = [
            {key: c[key] - b.get(key, 0) for key in c}
            for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.update(b)
        self.graph, self.token = graph, token

    def run(self, batches: Mapping, k: int) -> torch.Tensor:
        """K steps over ``batches`` ((K, B, ...) a key); the (K,) losses."""
        trainer = self.trainer
        self._stage(batches, k)
        done = 0
        if trainer._graph_warm < WARMUP_STEPS:
            side = torch.cuda.Stream(device=trainer.device)
            side.wait_stream(torch.cuda.current_stream(trainer.device))
            with torch.cuda.stream(side):
                while done < k and trainer._graph_warm < WARMUP_STEPS:
                    self._body()
                    trainer._graph_warm += 1
                    done += 1
            torch.cuda.current_stream(trainer.device).wait_stream(side)
        if done < k:
            token = trainer._graph_token()
            if self.graph is None or token != self.token:
                self._capture(token)
            counters = kernel_counters()
            for _ in range(k - done):
                self.graph.replay()
                for c, add in zip(counters, self.captured_launches):
                    for key, n in add.items():
                        c[key] += n
        return self.losses[:k].clone()
