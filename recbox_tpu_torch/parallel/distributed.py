"""Multi-process initialization and per-rank input wiring.

Counterpart of `recbox_tpu/parallel/distributed.py` (:31-92). JAX calls
`jax.distributed.initialize` once a host and then sees every device of the
slice; PyTorch runs one process a device, so here each rank is one
process with one local device (``local_devices`` is 1: a divergence,
`ROADMAP.md` Queue C).

* `initialize_distributed(coordinator_address, num_processes,
  process_id)`: `init_process_group` over ``tcp://<address>``, or over
  ``env://`` (torchrun's MASTER_ADDR / WORLD_SIZE / RANK) when all three
  are None — the counterpart of Cloud TPU's auto-detect. With none of
  torchrun's variables either, a world of one. The backend is NCCL on
  ``cuda:LOCAL_RANK`` (raises without a CUDA device or NCCL) unless
  ``device='cpu'`` asks for gloo.
* `merge_host_metrics`: the sample-weighted all-reduce of every rank's
  metrics in float64, exact zeros for a rank of weight <= 0 (:57-84).
* `host_shard_loader`: a `data.shards.ShardLoader` over this rank's
  disjoint shard partition, by its 'data' coordinate when a mesh is given
  (ranks of one 'data' coordinate must read the same rows) and by rank
  otherwise. JAX partitions by process, which holds every device of a
  host; one device a process puts the 'model' axis across processes, so
  the partition follows 'data'.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["initialize_distributed", "host_shard_loader", "process_info",
           "merge_host_metrics"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> None:
    """`init_process_group` with the reference's explicit rendezvous
    (``host:port`` / world size / rank), or torchrun's environment when
    all three are None. Call once a process, before any collective."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        backend = "gloo"
    else:
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError(
                "initialize_distributed runs NCCL on cuda:LOCAL_RANK by "
                "default and finds no CUDA device or no NCCL; pass "
                "device='cpu' for gloo")
        backend = "nccl"
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if None in explicit:
            raise ValueError("pass coordinator_address, num_processes and "
                             "process_id together, or none of them")
        init = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        init, world, rank = "env://", None, None
    else:
        init, world, rank = f"tcp://127.0.0.1:{_free_port()}", 1, 0
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", 0 if rank is None
                                   else rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kwargs = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend, init_method=init, **kwargs)
    logger.info("distributed: process %d/%d over %s", dist.get_rank(),
                dist.get_world_size(), backend)


def process_info() -> dict:
    """JAX's keys; one device a process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized()
            else 0, "process_count": world, "local_devices": 1,
            "global_devices": world}


def merge_host_metrics(metrics: dict, weight: float) -> dict:
    """Sample-weighted cross-rank metric merge.

    Each rank evaluates ITS shard of the eval data and calls this with its
    metric dict and its sample count; the merge is the weighted mean over
    ranks, in float64. A rank with weight <= 0 (an empty shard, whose
    metrics may be NaN) contributes exact zeros. One process returns the
    input unchanged."""
    from recbox_tpu_torch.parallel.mesh import all_gather
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    if weight <= 0:
        local = torch.zeros(len(keys) + 1, dtype=torch.float64)
    else:
        local = torch.tensor([metrics[k] * weight for k in keys] + [weight],
                             dtype=torch.float64)
    if dist.get_backend() == "nccl":
        local = local.cuda()
    gathered = all_gather(local[None]).cpu()           # (P, M + 1)
    totals = gathered.sum(dim=0)
    total_w = max(float(totals[-1]), 1e-12)
    return {k: float(totals[i]) / total_w for i, k in enumerate(keys)}


def host_shard_loader(path: str, mesh=None, **loader_kwargs):
    """A `ShardLoader` reading THIS rank's disjoint shard partition: by its
    'data' coordinate under ``mesh``, else by rank."""
    from recbox_tpu_torch.data.shards import ShardLoader
    if mesh is not None:
        from recbox_tpu_torch.parallel.mesh import (
            DATA_AXIS, mesh_coords, mesh_shape,
        )
        index, count = mesh_coords(mesh)[0], mesh_shape(mesh)[DATA_AXIS]
    else:
        info = process_info()
        index, count = info["process_index"], info["process_count"]
    return ShardLoader(path, shard_index=index, num_shard_readers=count,
                       **loader_kwargs)
