"""Device mesh and sharding over `torch.distributed`.

Counterpart of `recbox_tpu/parallel/mesh.py` (:39-99). JAX builds one
SPMD mesh over many devices in one process, and GSPMD emits the
collectives from the sharding metadata. PyTorch runs one process a device,
so a mesh here is the `torch.distributed` world laid out as a
``('data', 'model')`` `DeviceMesh` (rank r at coordinate
``(r // n_model, r % n_model)``), over NCCL on the card and gloo on the
CPU, and the collectives are written out by hand:

* `make_mesh`: the world as ``(n_data, n_model)``; ``device=None`` is NCCL
  on ``cuda:LOCAL_RANK``, ``device='cpu'`` gloo. A gloo world whose tensors
  live on a CUDA device (``device='cuda:0'``, two ranks sharing one card)
  stages every collective through the host, explicitly;
* `param_partition_specs`: ``(('data', 'model'), None)`` for a row-sharded
  `FeatureEmbedding` table (its spec's ``shard_table``, else the module's
  ``shard_tables``, JAX `nn/embedding.py:212-219`), ``()`` for every other
  parameter (a model's own bare tables replicate here);
* `shard_params`: rank r keeps rows ``[r·S, (r+1)·S)`` of each sharded
  table, S = ceil(V / N), in the combined-grid order; a ragged last shard
  is padded with zero rows that no view shows;
* `shard_batch`: each rank passes ITS rows and the global batch is their
  union over 'data' (JAX's multi-process contract, :79-99); ranks that
  share a 'data' coordinate must pass the same rows;
* `sharded_embedding`: a sharded table's lookup, an autograd function
  whose forward all-gathers the ids over 'data', gathers the rows this
  rank owns (zeros elsewhere), all-reduces them over the world and keeps
  this rank's rows, and whose backward all-gathers the row gradients over
  'data' and adds the owned ones into the local shard's gradient: the
  exchange `placement.predict_step_comm_bytes` models. `sharded_rows` and
  `owned_grads` are its two halves, which the trainers that update rows
  outside autograd call;
* `export_state` / `import_state`: a state dict's row shards gathered
  whole (or as DTensors) and split again, keyed by a {name: RowShard} map;
* the collective wrappers (`all_gather`, `all_reduce_`, `barrier`) through
  which every collective of the port goes, and their recorder
  (`record_collectives`, read by `inspect.collective_stats`). On a group
  of one they issue nothing, as the model predicts: a world of one runs
  the unsharded path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from recbox_tpu_torch.parallel.inspect import CollectiveOp

__all__ = ["make_mesh", "shard_params", "shard_batch", "param_partition_specs",
           "replicate_specs", "DATA_AXIS", "MODEL_AXIS", "mesh_shape",
           "mesh_device", "device_on_mesh", "mesh_coords", "RowShard",
           "row_bounds", "local_rows", "gather_rows", "export_state",
           "import_state", "sharded_embedding", "sharded_rows",
           "owned_grads", "all_gather", "all_reduce_", "barrier",
           "record_collectives", "world_size", "rank", "SHARDED_SPEC", "table_shards",
           "full_state_dict"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SHARDED_SPEC = ((DATA_AXIS, MODEL_AXIS), None)


# -- the world ------------------------------------------------------------------

def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(num_model_shards: int = 1, devices: Optional[Sequence] = None,
              device=None):
    """The world as a ``('data', 'model')`` `DeviceMesh` of shape
    ``(world / num_model_shards, num_model_shards)``.

    ``devices``: the world's ranks in order (the mesh spans the whole
    world); None = all. ``device``: where this rank's tensors live. None
    is ``cuda:LOCAL_RANK`` over NCCL (raises without a CUDA device or
    NCCL); ``'cpu'`` is gloo; an explicit CUDA device over a gloo world
    stages each collective through the host. Without a process group one
    is started (`distributed.initialize_distributed`: torchrun's variables,
    else a world of one). Raises ValueError where the world does not
    divide into ``num_model_shards`` (JAX asserts)."""
    from torch.distributed.device_mesh import init_device_mesh

    from recbox_tpu_torch.parallel.distributed import initialize_distributed
    if not dist.is_initialized():
        initialize_distributed(device=device)
    n = dist.get_world_size()
    if devices is not None and [int(d) for d in devices] != list(range(n)):
        raise ValueError(f"a mesh spans the whole world of {n} ranks in "
                         f"order; got devices={list(devices)}")
    if num_model_shards < 1 or n % num_model_shards:
        raise ValueError(f"{n} devices not divisible by model shards "
                         f"{num_model_shards}")
    backend = dist.get_backend()
    dev = _tensor_device(device, backend)
    # a gloo world's groups are host-side whatever its tensors' device
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            (n // num_model_shards, num_model_shards),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    mesh.recbox_device = dev
    return mesh


def _tensor_device(device, backend: str) -> torch.device:
    if device is None:
        if backend != "nccl":
            raise RuntimeError(
                f"the default mesh is NCCL on cuda:LOCAL_RANK and the "
                f"process group is {backend}; pass device='cpu' for gloo")
        if not torch.cuda.is_available():
            raise RuntimeError("the default mesh needs a CUDA device")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        return torch.device("cuda", local)
    dev = torch.device(device)
    if dev.type == "cpu" and backend != "gloo":
        raise RuntimeError(f"a CPU mesh needs a gloo process group, not "
                           f"{backend}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_shape(mesh) -> Dict[str, int]:
    """{'data': n_data, 'model': n_model}, JAX's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def mesh_device(mesh) -> torch.device:
    return mesh.recbox_device


def device_on_mesh(mesh, device=None) -> torch.device:
    """The mesh's device, refusing a ``device`` that names another (a
    bare ``'cuda'`` names the mesh's card)."""
    dev = mesh_device(mesh)
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None
                                     and want.index != dev.index):
            raise ValueError(f"device={device} differs from the mesh's "
                             f"{dev}")
    return dev


def mesh_coords(mesh) -> Tuple[int, int]:
    """This rank's (data, model) coordinate."""
    d, m = mesh.get_coordinate()
    return int(d), int(m)


def _group(mesh, axis: Optional[str]):
    """The process group of one axis, or the world (``axis=None``)."""
    if mesh is None or axis is None:
        return None
    return mesh.get_group(axis)


# -- the collectives and their recorder -----------------------------------------

_RECORDERS: List[List[CollectiveOp]] = []
_HLO_TYPES = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.int32: "s32", torch.int64: "s64",
              torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


@contextlib.contextmanager
def record_collectives():
    """Collect a `CollectiveOp` for every collective issued inside."""
    ops: List[CollectiveOp] = []
    _RECORDERS.append(ops)
    try:
        yield ops
    finally:
        _RECORDERS.remove(ops)


def _record(kind: str, result: torch.Tensor) -> None:
    if not _RECORDERS:
        return
    shape = f"{_HLO_TYPES.get(result.dtype, str(result.dtype))}" \
            f"[{','.join(str(s) for s in result.shape)}]"
    op = CollectiveOp(kind=kind, result_shape=shape,
                      bytes=result.numel() * result.element_size(),
                      line=f"{kind} {shape}")
    for ops in _RECORDERS:
        ops.append(op)


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _staged(x: torch.Tensor, group) -> bool:
    """gloo's collectives on a CUDA tensor go through the host (a gloo
    world sharing one card)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, mesh=None, axis: Optional[str] = None,
               dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (every
    rank passes the same shape); ``x`` itself on a group of one."""
    group = _group(mesh, axis)
    n = _size(group)
    if n == 1:
        return x
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if staged:
        out = out.to(x.device)
    _record("all-gather", out)
    return out


def all_reduce_(x: torch.Tensor, mesh=None, axis: Optional[str] = None
                ) -> torch.Tensor:
    """Sum ``x`` over the group in place; returns it (untouched on a group
    of one)."""
    group = _group(mesh, axis)
    if _size(group) == 1:
        return x
    if _staged(x, group) or not x.is_contiguous():
        buf = x.detach().cpu() if _staged(x, group) else x.contiguous()
        dist.all_reduce(buf, group=group)
        x.copy_(buf)
    else:
        dist.all_reduce(x, group=group)
    _record("all-reduce", x)
    return x


def barrier(mesh=None, axis: Optional[str] = None) -> None:
    group = _group(mesh, axis)
    if _size(group) > 1:
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group,
                         device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)


# -- row sharding ---------------------------------------------------------------

@dataclasses.dataclass
class RowShard:
    """One rank's rows of a table row-sharded over the combined grid:
    global rows ``[lo, lo + shard_rows)`` of ``rows``, padded past them."""
    mesh: Any
    rows: int
    shard_rows: int
    lo: int

    @property
    def valid(self) -> int:
        """Rows of the shard that exist (the rest is padding)."""
        return max(0, min(self.shard_rows, self.rows - self.lo))


def row_bounds(rows: int, mesh) -> RowShard:
    n = world_size() if mesh is not None else 1
    s = math.ceil(rows / n) if n > 1 else rows
    return RowShard(mesh, int(rows), int(s), rank() * s if n > 1 else 0)


def local_rows(full: torch.Tensor, mesh, device=None) -> torch.Tensor:
    """This rank's padded (S, ...) shard of ``full`` (V, ...); ``full``
    itself on a world of one."""
    b = row_bounds(full.shape[0], mesh)
    dev = full.device if device is None else device
    if b.shard_rows == full.shape[0] and b.lo == 0:
        return full.to(dev)
    out = torch.zeros((b.shard_rows,) + tuple(full.shape[1:]),
                      dtype=full.dtype, device=dev)
    out[:b.valid] = full[b.lo:b.lo + b.valid].to(dev)
    return out


def gather_rows(local: torch.Tensor, rows: int, mesh) -> torch.Tensor:
    """The whole (rows, ...) table from every rank's padded shard (a
    collective: every rank calls it)."""
    full = all_gather(local, mesh)
    return full[:rows]


def _world_mesh(mesh):
    """A one-axis mesh over the world beside ``mesh`` (made once), for
    the DTensors of a sharded checkpoint."""
    flat = getattr(mesh, "recbox_world", None)
    if flat is None:
        from torch.distributed.device_mesh import init_device_mesh
        flat = init_device_mesh(mesh.device_type, (world_size(),),
                                mesh_dim_names=("world",))
        mesh.recbox_world = flat
    return flat


def _export_rows(local: torch.Tensor, shard: RowShard, sharded: bool):
    if not sharded:
        return gather_rows(local.detach(), shard.rows, shard.mesh)
    from torch.distributed.tensor import DTensor, Shard
    view = local.detach()[:shard.valid]
    if shard.mesh.device_type == "cpu" and view.is_cuda:
        view = view.cpu()
    return DTensor.from_local(view, _world_mesh(shard.mesh), [Shard(0)],
                              run_check=False,
                              shape=torch.Size((shard.rows,)
                                               + tuple(local.shape[1:])),
                              stride=local.stride())


def _import_rows(src, shard: RowShard, device) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if not isinstance(src, DTensor):
        return local_rows(src, shard.mesh, device)
    part = src.to_local()
    out = torch.zeros((shard.shard_rows,) + tuple(part.shape[1:]),
                      dtype=part.dtype, device=device)
    out[:part.shape[0]] = part.to(device)
    return out


def export_state(tensors: Mapping[str, Any], shards: Mapping[str, RowShard],
                 sharded: bool = False) -> Dict[str, Any]:
    """``tensors`` for a state dict: each entry that ``shards`` names (this
    rank's padded row shard) gathered whole (a collective: every rank
    calls it) or, with ``sharded``, a DTensor of this rank's rows over the
    world (no gather; `training.checkpoint.OrbaxCheckpointer` writes each
    rank's own); every other entry as it is."""
    return {k: (_export_rows(v, shards[k], sharded) if k in shards else v)
            for k, v in tensors.items()}


def import_state(state: Mapping[str, Any], shards: Mapping[str, RowShard],
                 device) -> Dict[str, Any]:
    """The inverse of `export_state`: this rank's padded shard of each
    entry that ``shards`` names (a whole tensor or a DTensor); every other
    entry as it is."""
    return {k: (_import_rows(v, shards[k], device) if k in shards else v)
            for k, v in state.items()}


def sharded_rows(ids: torch.Tensor, table: torch.Tensor, shard: RowShard
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows of this rank's ids, the ids of the global batch): the
    forward exchange without autograd."""
    mesh = shard.mesh
    flat = ids.reshape(-1)
    gids = all_gather(flat, mesh, DATA_AXIS)
    local = gids.to(torch.int64) - shard.lo
    mask = (local >= 0) & (local < shard.shard_rows)
    got = table.index_select(0, torch.clamp(local, 0, shard.shard_rows - 1))
    got = torch.where(mask[:, None], got, torch.zeros((), dtype=got.dtype,
                                                      device=got.device))
    all_reduce_(got, mesh)
    d = mesh_coords(mesh)[0]
    n = flat.numel()
    own = got[d * n:(d + 1) * n]
    return own.reshape(tuple(ids.shape) + (table.shape[1],)), gids


def owned_grads(g: torch.Tensor, gids: torch.Tensor, shard: RowShard
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The owner's half of the exchange's backward: ``g``, this rank's
    (n, ...) row gradients, all-gathered over 'data', and of the global
    batch's ids ``gids`` those this rank owns. Returns (their local row
    numbers, their row gradients): every occurrence of the owned ids."""
    g_all = all_gather(g.contiguous(), shard.mesh, DATA_AXIS)
    local = gids.to(torch.int64) - shard.lo
    sel = torch.nonzero((local >= 0) & (local < shard.shard_rows)
                        ).squeeze(1)
    return local[sel], g_all.index_select(0, sel)


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, shard):
        rows, gids = sharded_rows(ids, table, shard)
        ctx.save_for_backward(gids)
        ctx.shard = shard
        ctx.table_shape = tuple(table.shape)
        return rows

    @staticmethod
    def backward(ctx, grad):
        gids, = ctx.saved_tensors
        lids, g = owned_grads(grad.reshape(-1, ctx.table_shape[1]), gids,
                              ctx.shard)
        out = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        out.index_add_(0, lids, g)
        return out, None, None


def sharded_embedding(ids: torch.Tensor, table: torch.Tensor,
                      shard: RowShard) -> torch.Tensor:
    """``F.embedding(ids, full_table)`` for a table row-sharded over the
    mesh (``table`` is this rank's padded shard): the exchange of
    `_ShardedLookup`. Every rank of the world calls it, and ranks of one
    'data' coordinate with the same ids."""
    if world_size() == 1:
        return F.embedding(ids, table)
    return _ShardedLookup.apply(table, ids, shard)


# -- parameter specs and placement ----------------------------------------------

def _feature_embeddings(module: torch.nn.Module):
    from recbox_tpu_torch.nn.embedding import FeatureEmbedding
    for mname, m in module.named_modules():
        if isinstance(m, FeatureEmbedding):
            yield mname, m


def _table_param_name(mname: str, tname: str) -> str:
    return f"{mname}.tables.{tname}" if mname else f"tables.{tname}"


def param_partition_specs(module: torch.nn.Module) -> Dict[str, tuple]:
    """{parameter name: spec}: `SHARDED_SPEC` for a row-sharded
    `FeatureEmbedding` table, ``()`` (replicated) for every other."""
    sharded = {_table_param_name(mname, t)
               for mname, m in _feature_embeddings(module)
               for t in m.tables if m.table_sharded(t)}
    return {n: (SHARDED_SPEC if n in sharded else ())
            for n, _ in module.named_parameters()}


def replicate_specs(tree: Mapping[str, Any]) -> Dict[str, tuple]:
    return {k: () for k in tree}


@torch.no_grad()
def shard_params(module_or_params, mesh, specs: Optional[Mapping] = None):
    """Row-shard every parameter whose spec is `SHARDED_SPEC`.

    A module: each such `FeatureEmbedding` table keeps this rank's padded
    shard in place (the same Parameter) and its module records the
    `RowShard`, so its lookups run the exchange; returns the module. A
    {name: tensor} dict (``specs`` naming the sharded entries): returns a
    new dict of the local shards."""
    if isinstance(module_or_params, torch.nn.Module):
        module = module_or_params
        specs = specs if specs is not None else param_partition_specs(module)
        for mname, m in _feature_embeddings(module):
            for t, p in m.tables.items():
                if specs.get(_table_param_name(mname, t)) != SHARDED_SPEC:
                    continue
                shard = row_bounds(p.shape[0], mesh)
                p.data = local_rows(p.data, mesh)
                m.table_shards[t] = shard
        return module
    specs = specs or {}
    return {k: (local_rows(v, mesh) if specs.get(k) == SHARDED_SPEC else v)
            for k, v in module_or_params.items()}


def table_shards(module: torch.nn.Module) -> Dict[str, RowShard]:
    """{parameter name: RowShard} of the module's row-sharded tables."""
    return {_table_param_name(mname, t): shard
            for mname, m in _feature_embeddings(module)
            for t, shard in m.table_shards.items()}


def full_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every row-sharded table gathered whole
    (a collective under a mesh: every rank calls it)."""
    state = dict(module.state_dict())
    for name, shard in table_shards(module).items():
        state[name] = gather_rows(state[name].detach(), shard.rows,
                                  shard.mesh)
    return state


def shard_batch(batch: Mapping[str, Any], mesh, check: bool = True
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch as tensors on the mesh's
    device: each rank passes its LOCAL rows (the global batch is their
    union over 'data', in 'data' order). With ``check``, ranks of one
    'data' coordinate must pass the same rows (a fingerprint of every
    column is compared over 'model'), else ValueError."""
    dev = mesh_device(mesh)
    out = {k: (v if isinstance(v, torch.Tensor)
               else torch.as_tensor(np.asarray(v))).to(dev)
           for k, v in batch.items()}
    if check and mesh_shape(mesh)[MODEL_AXIS] > 1:
        keys = sorted(out)
        prints = torch.stack([_fingerprint(out[k]) for k in keys])
        every = all_gather(prints[None], mesh, MODEL_AXIS)
        if not bool(torch.all(every == every[:1])):
            raise ValueError(
                "ranks of one 'data' coordinate passed different rows: "
                "the batch of a 'data' shard must be the same on each of "
                "its 'model' ranks")
    return out


def _fingerprint(x: torch.Tensor) -> torch.Tensor:
    v = torch.nan_to_num(x.detach().reshape(-1).to(torch.float64))
    w = torch.arange(1, v.numel() + 1, dtype=torch.float64, device=v.device)
    return torch.stack([torch.sum(v * w), torch.tensor(float(v.numel()),
                                                       dtype=torch.float64,
                                                       device=v.device)])
