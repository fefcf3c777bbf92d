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
  ``shard_tables``, JAX `nn/embedding.py:212-219`) and for a model's own
  table marked with `shard_rows` where the model makes it (JAX's
  ``nn.with_partitioning`` on the sequential, NCF, Item2Vec,
  multi-interest, graph and knowledge tables), ``()`` for every other
  parameter;
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
* a model's own sharded tables: `lookup` (the exchange, or the model's
  indexing without a mesh), `shard_slice` (a replicated per-row parameter
  cut to the shard's rows), `whole_table` (the table all-gathered, for the
  scorers that read every row and the propagation models, once a
  forward), `whole_tables` (a model's tables gathered for `lookup`
  inside a call), and the vocabulary-parallel full softmax:
  `sharded_logits` gives `ShardedLogits` (the global batch's rows against
  this rank's columns, which refuse any use but theirs),
  `vocab_parallel_ce` their CE (3·B floats reduced a step, no term in V;
  weighted as `fused_softmax_ce` is, for the cloze / MIP heads) and
  `sharded_hit_positions` the evaluators' ranks;
* the loss terms that span JAX's global batch: `module_mesh` (the mesh
  `shard_params` placed a model on), `inbatch_columns` (the global batch's
  in-batch negatives, their gradient summed over 'data'), `mark_inbatch` /
  `inbatch_layout` (where each row's positive sits) and `data_shards` (the
  weight of a sum over this rank's rows);
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
import weakref
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
           "full_state_dict", "shard_rows", "row_shard", "lookup",
           "shard_slice", "gather_batch", "whole_table", "whole_tables",
           "ShardedLogits",
           "sharded_logits", "vocab_parallel_ce", "sharded_hit_positions",
           "module_mesh", "data_shards", "inbatch_columns", "mark_inbatch",
           "inbatch_layout"]

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


def all_reduce_(x: torch.Tensor, mesh=None, axis: Optional[str] = None,
                op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the group in place (``op`` 'sum' or 'max');
    returns it (untouched on a group of one)."""
    group = _group(mesh, axis)
    if _size(group) == 1:
        return x
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _staged(x, group) or not x.is_contiguous():
        buf = x.detach().cpu() if _staged(x, group) else x.contiguous()
        dist.all_reduce(buf, op=rop, group=group)
        x.copy_(buf)
    else:
        dist.all_reduce(x, op=rop, group=group)
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


# -- a model's own tables -------------------------------------------------------

_MARK = "recbox_shard_rows"
_SHARD = "recbox_row_shard"


def shard_rows(p: torch.nn.Parameter) -> torch.nn.Parameter:
    """Mark a model's own table for row-sharding under a mesh, where the
    model makes it (flax's ``nn.with_partitioning(init, (('data',
    'model'), None))``); returns ``p``. `param_partition_specs` gives it
    `SHARDED_SPEC` and `shard_params` keeps this rank's rows in it."""
    setattr(p, _MARK, True)
    return p


def row_shard(p: torch.Tensor) -> Optional[RowShard]:
    """The `RowShard` of a marked table that `shard_params` sharded over a
    world of more than one rank; None otherwise, where the model runs its
    unsharded path (a world of one keeps the whole table)."""
    shard = getattr(p, _SHARD, None)
    return shard if shard is not None and world_size() > 1 else None


# inside `whole_tables`: {id(marked parameter): its whole table}
_WHOLE: Dict[int, torch.Tensor] = {}


def lookup(table: torch.Tensor, ids: torch.Tensor,
           shard: Optional[RowShard] = None,
           embedding: bool = False) -> torch.Tensor:
    """The rows ``ids`` of a model's own table: the marked parameter (its
    `row_shard` by default), or a per-row function of it, such as a
    model's augmented scoring table, with the parameter's ``shard``. Under
    a mesh the exchange of `sharded_embedding`, or inside `whole_tables`
    the rows of the table's whole copy; without one the indexing the
    model did before: ``F.embedding(ids, table)`` with ``embedding``,
    else ``table[ids]``."""
    whole = _WHOLE.get(id(table))
    if whole is not None:
        table, shard = whole, None
    else:
        shard = shard if shard is not None else row_shard(table)
    if shard is None:
        return F.embedding(ids, table) if embedding else table[ids]
    return _ShardedLookup.apply(table, ids, shard)


class _ShardSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, full, shard):
        ctx.shard, ctx.rows = shard, full.shape[0]
        out = full.new_zeros((shard.shard_rows,) + tuple(full.shape[1:]))
        out[:shard.valid] = full[shard.lo:shard.lo + shard.valid]
        return out

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        out = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        out[s.lo:s.lo + s.valid] = grad[:s.valid]
        # each rank's gradient covers its own rows, from the global batch:
        # the 'model' sum here and the trainer's 'data' sum give every
        # row once
        return all_reduce_(out, s.mesh, MODEL_AXIS), None


def shard_slice(p: torch.Tensor, shard: Optional[RowShard]) -> torch.Tensor:
    """This rank's padded rows of a REPLICATED per-row parameter (TransRec's
    and FOSSIL's item bias) beside a sharded table; ``p`` itself without a
    shard. Its backward sums the (V, ...) gradient over 'model' (a V term
    of the replicated parameter, as its 'data' all-reduce is)."""
    return p if shard is None else _ShardSlice.apply(p, shard)


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, grad_axis):
        ctx.mesh, ctx.n, ctx.axis = mesh, x.shape[0], grad_axis
        out = all_gather(x, mesh, DATA_AXIS)
        return x.clone() if out is x else out

    @staticmethod
    def backward(ctx, grad):
        # every rank's rows of the global batch reach every rank's use of
        # them: the sum over the ranks whose uses differ, then this rank's
        # rows
        g = all_reduce_(grad.contiguous().clone(), ctx.mesh, ctx.axis)
        d = mesh_coords(ctx.mesh)[0]
        return g[d * ctx.n:(d + 1) * ctx.n], None, None


def gather_batch(x: torch.Tensor, mesh,
                 grad_axis: Optional[str] = None) -> torch.Tensor:
    """The global batch's rows of ``x`` (this rank's, all-gathered over
    'data'), differentiable: the backward sums the gradient over
    ``grad_axis`` and keeps this rank's rows. The world (None) where each
    rank scores its own columns (`sharded_logits`: every rank's columns add
    their share); 'data' where the ranks of one 'data' coordinate compute
    the same thing (in-batch negatives: a world sum would count each row's
    gradient n_model times)."""
    return _GatherData.apply(x, mesh, grad_axis)


# -- the global batch's in-batch negatives --------------------------------------

# a mark on a model's in-batch scores under a mesh: (mesh, this rank's
# first row in the global batch)
_INBATCH = "recbox_inbatch"
# {model: the mesh `shard_params` sharded it over}, held beside the model
# rather than on it, so a deep copy of a model copies no process group
_MODULE_MESH: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def module_mesh(module: torch.nn.Module):
    """The mesh `shard_params` placed ``module`` on, over a world of more
    than one rank; None otherwise (the model runs its unsharded path). A
    model reads it where its loss terms span the global batch, as JAX's
    sharded step sees it: in-batch negatives (`inbatch_columns`), sums over
    the batch's rows (`data_shards`)."""
    mesh = _MODULE_MESH.get(module)
    return mesh if mesh is not None and world_size() > 1 else None


def data_shards(module: torch.nn.Module) -> int:
    """The 'data' coordinates of ``module``'s mesh (1 without one): the
    weight of a sum over this rank's rows, which the trainer's mean over
    'data' (`Trainer._mesh_loss`) divides by it, so that the world's sum
    is the global batch's, as in JAX's sharded step."""
    mesh = module_mesh(module)
    return 1 if mesh is None else mesh_shape(mesh)[DATA_AXIS]


def inbatch_columns(x: torch.Tensor, mesh) -> Tuple[torch.Tensor, int]:
    """(the global batch's rows of ``x``, this rank's first row among
    them): the columns of in-batch scores under a mesh (`gather_batch`
    over 'data', its gradient summed over 'data': the ranks of one 'data'
    coordinate score alike). Integer ``x`` (ids) is gathered without
    autograd."""
    d = mesh_coords(mesh)[0]
    if x.is_floating_point():
        return gather_batch(x, mesh, DATA_AXIS), d * x.shape[0]
    return all_gather(x.contiguous(), mesh, DATA_AXIS), d * x.shape[0]


def mark_inbatch(scores: torch.Tensor, mesh, offset: int) -> torch.Tensor:
    """Mark (R, N) in-batch ``scores`` of this rank's R rows against the
    global batch's N columns, row r's positive at column ``offset + r``,
    for the in-batch losses (`inbatch_layout`); returns ``scores``."""
    setattr(scores, _INBATCH, (mesh, int(offset)))
    return scores


def inbatch_layout(scores: torch.Tensor):
    """(mesh, offset) of scores marked by `mark_inbatch`, else None (a
    square (B, B) block, the positives on its diagonal)."""
    return getattr(scores, _INBATCH, None)


class _WholeTable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, shard):
        ctx.shard = shard
        return gather_rows(local, shard.rows, shard.mesh)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        # this rank's rows of the batch reached every row: the 'data' sum
        # gives each row the global batch's gradient once
        g = all_reduce_(grad.contiguous().clone(), s.mesh, DATA_AXIS)
        out = grad.new_zeros((s.shard_rows,) + tuple(grad.shape[1:]))
        out[:s.valid] = g[s.lo:s.lo + s.valid]
        return out, None


def whole_table(p: torch.Tensor, shard: Optional[RowShard] = None
                ) -> torch.Tensor:
    """The whole (V, ...) table of a marked parameter, differentiable: its
    shards all-gathered over the world (V·D·4 bytes), the backward's
    gradient summed over 'data' and cut to this rank's rows (V·D·4 more);
    ``p`` itself unsharded. A collective: every rank calls it as often.
    For the scorers that read every row (the pair-scoring models'
    ``full_scores``, ENMF's Gram term) and the propagation models, which
    gather each table once a forward and run their hops on the whole
    tables over replicated edges: no term in the edge count, the table
    and its Adam moments divided by the world (3·V·D·4 / N bytes a rank),
    the step's peak not (the gathered table and the hops' (V, D)
    activations are whole on every rank)."""
    shard = shard if shard is not None else row_shard(p)
    return p if shard is None else _WholeTable.apply(p, shard)


@contextlib.contextmanager
def whole_tables(model: torch.nn.Module):
    """Inside, `lookup` reads each of the model's row-sharded tables from
    its whole copy, gathered once on entry (`whole_table`: V·D·4 bytes
    each way a table): for the pair-scoring models' ``full_scores``, which
    run f(u, i) on every item. A collective on entry: every rank enters."""
    tables = [p for _, p in model.named_parameters()
              if row_shard(p) is not None]
    for p in tables:
        _WHOLE[id(p)] = whole_table(p)
    try:
        yield
    finally:
        for p in tables:
            _WHOLE.pop(id(p), None)


class ShardedLogits:
    """Scores over a vocabulary row-sharded over the mesh: ``local`` (R, S)
    f32, the global batch's R rows (all-gathered over 'data', `gather_batch`)
    against this rank's S columns, global ids ``shard.lo + j``; columns at
    or past ``vocab`` (the shard's padding, BERT4Rec's and S3Rec's [MASK]
    row) take no part. A row's softmax needs every rank's columns, so only
    the vocabulary-parallel consumers read it: `ops.losses.full_softmax_loss`
    (`vocab_parallel_ce`) and the evaluators' hit positions
    (`sharded_hit_positions`); any other use raises TypeError, where JAX's
    sharded (B, V) array reads like any other (`ROADMAP.md` Queue C 59)."""

    __slots__ = ("local", "shard", "vocab", "rows")

    def __init__(self, local: torch.Tensor, shard: RowShard, vocab: int,
                 rows: int):
        object.__setattr__(self, "local", local)
        object.__setattr__(self, "shard", shard)
        object.__setattr__(self, "vocab", int(vocab))
        object.__setattr__(self, "rows", int(rows))   # this rank's rows

    def _refuse(self, what):
        raise TypeError(
            f"{what} on ShardedLogits: each rank holds only its columns of "
            f"the vocabulary; use full_softmax_loss or the evaluators' hit "
            f"positions, which reduce over the mesh")

    def __getattr__(self, name):
        self._refuse(f"attribute {name!r}")

    def __setattr__(self, name, value):
        self._refuse(f"setting {name!r}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise TypeError(f"{getattr(func, '__name__', func)} on "
                        f"ShardedLogits: use full_softmax_loss or the "
                        f"evaluators' hit positions")

    def __array__(self, *args, **kwargs):
        self._refuse("conversion to an array")

    def __repr__(self):
        return (f"ShardedLogits(rows={tuple(self.local.shape)[0]}, "
                f"columns {self.shard.lo}..{self.shard.lo + self.valid} of "
                f"{self.vocab})")

    @property
    def valid(self) -> int:
        """This rank's columns inside the vocabulary."""
        return max(0, min(self.shard.shard_rows, self.vocab - self.shard.lo))


def sharded_logits(user: torch.Tensor, table: torch.Tensor,
                   shard: RowShard, vocab: int, temperature: float = 1.0,
                   dtype: Optional[torch.dtype] = None) -> ShardedLogits:
    """``user @ table.T / temperature`` over a row-sharded ``table`` (this
    rank's (S, D) shard): the users gathered over 'data' (B·D·4 bytes, and
    their gradient's world sum), this rank's (B, S) block in f32, the
    product in ``dtype`` (bf16 compute: the operands rounded, f32 out, as
    the unsharded ``full_scores``)."""
    n = user.shape[0]
    u = gather_batch(user, shard.mesh)
    t = table
    if dtype is not None:
        u, t = u.to(dtype), t.to(dtype)
        if u.dtype == torch.bfloat16 and u.device.type == "cpu":
            u, t = u.float(), t.float()
    return ShardedLogits((u @ t.T).float() / temperature, shard, vocab, n)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, targets, shard, vocab, n_own, weights):
        mesh, lo = shard.mesh, shard.lo
        valid = max(0, min(local.shape[1], vocab - lo))
        z = local[:, :valid]
        r = local.shape[0]
        m = z.amax(dim=1) if valid else local.new_full((r,), float("-inf"))
        m = all_reduce_(m.contiguous(), mesh, op="max")
        e = torch.exp(z - m[:, None])
        rel = targets.to(torch.int64) - lo
        owned = (rel >= 0) & (rel < valid)
        rel = torch.clamp(rel, 0, max(valid - 1, 0))
        t = torch.where(owned, z.gather(1, rel[:, None])[:, 0], 0.0) \
            if valid else local.new_zeros((r,))
        st = torch.stack([e.sum(dim=1), t])
        all_reduce_(st, mesh)
        rows = -(st[1] - m - torch.log(st[0]))          # -log p[target]
        d = mesh_coords(mesh)[0]
        own = slice(d * n_own, (d + 1) * n_own)
        if weights is None:
            scale = None
            loss = torch.mean(rows[own])
        else:
            # n_data times this rank's share of sum(w·ce) / sum(w) over the
            # global batch: the trainer's mean over 'data' gives the whole;
            # a row of weight 0 adds nothing, NaN or not
            w = weights.to(local.dtype)
            scale = w * ((r // n_own) / w.sum())
            loss = torch.sum(torch.where(w[own] > 0, scale[own] * rows[own],
                                         0.0))
        ctx.save_for_backward(e / st[0][:, None], rel, owned, scale)
        ctx.shape, ctx.n_own = tuple(local.shape), n_own
        return loss

    @staticmethod
    def backward(ctx, g):
        p, rel, owned, scale = ctx.saved_tensors
        # the gradient of the world's objective on this rank's block: every
        # rank's loss is scaled alike by the trainer (1 / n_data), so each
        # row takes g times its weight in its owner's loss: g / n_own
        # unweighted (the 'data' shard's mean), else g · n_data · w / sum(w)
        out = torch.zeros(ctx.shape, dtype=p.dtype, device=p.device)
        rows = torch.nonzero(owned).squeeze(1)
        if scale is None:
            s = g / ctx.n_own
            out[:, :p.shape[1]] = p * s
            out[rows, rel[rows]] -= s
        else:
            s = (g * scale)[:, None]
            out[:, :p.shape[1]] = torch.where(s != 0, p * s, 0.0)
            out[rows, rel[rows]] -= s[rows, 0]
        return out, None, None, None, None, None


def vocab_parallel_ce(logits: ShardedLogits, targets: torch.Tensor,
                      weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The full-softmax CE of sharded logits: this rank's 'data' rows'
    mean of −log softmax[target], JAX's ``full_softmax_loss`` on the whole
    logits. Each row's max (max) and its sum of exps and target logit (sum)
    are reduced over the world, 3·B f32, besides the targets' all-gather
    over 'data' (B int32); no term in V. Its backward is softmax minus
    one-hot on the local block, with no collective.

    ``weights`` (this rank's rows, non-negative; a constant, as a mask):
    the weighted mean sum(w·ce) / sum(w) over the global batch, as
    `ops.fused_ce.fused_softmax_ce` takes it (a row of w = 0 an exact no-op
    in the loss and the gradient), returned as this rank's share times
    n_data, so that the mean over 'data' (the trainer's) is the whole; the
    weights are all-gathered over 'data' (B f32)."""
    mesh = logits.shard.mesh
    tg = all_gather(targets.reshape(-1).to(torch.int32), mesh, DATA_AXIS)
    if weights is not None:
        weights = all_gather(weights.reshape(-1).detach().to(torch.float32),
                             mesh, DATA_AXIS)
    return _VocabParallelCE.apply(logits.local, tg, logits.shard,
                                  logits.vocab, logits.rows, weights)


@torch.no_grad()
def sharded_hit_positions(logits: ShardedLogits, targets: torch.Tensor,
                          candidates: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """`quick_start.hit_positions` of sharded logits, for this rank's rows:
    'full' counts the columns that score above the target, or equal and
    before it, on each rank and sums the counts over the world (the
    target's score from its owner, B f32 and B int64); with ``candidates``
    (rows, 1 + N) their scores come from their owners (B·(1 + N) f32)."""
    mesh, lo = logits.shard.mesh, logits.shard.lo
    z, valid = logits.local, logits.valid
    d, n = mesh_coords(mesh)[0], logits.rows
    tg = all_gather(targets.reshape(-1).to(torch.int64), mesh, DATA_AXIS)

    def owned_scores(ids):
        rel = ids - lo
        own = (rel >= 0) & (rel < valid)
        got = torch.gather(z, 1, torch.clamp(rel, 0, z.shape[1] - 1))
        return all_reduce_(torch.where(own, got, 0.0), mesh)

    if candidates is not None:
        cand = all_gather(candidates.to(torch.int64), mesh, DATA_AXIS)
        cs = owned_scores(cand)
        pos = torch.sum(cs[:, 1:] > cs[:, :1], dim=1)
    else:
        ts = owned_scores(tg[:, None])
        cols = lo + torch.arange(valid, device=z.device)
        zz = z[:, :valid]
        pos = torch.sum((zz > ts) | ((zz == ts) & (cols[None, :]
                                                    < tg[:, None])), dim=1)
        all_reduce_(pos, mesh)
    return pos[d * n:(d + 1) * n]


# -- parameter specs and placement ----------------------------------------------

def _feature_embeddings(module: torch.nn.Module):
    from recbox_tpu_torch.nn.embedding import FeatureEmbedding
    for mname, m in module.named_modules():
        if isinstance(m, FeatureEmbedding):
            yield mname, m


def _table_param_name(mname: str, tname: str) -> str:
    return f"{mname}.tables.{tname}" if mname else f"tables.{tname}"


def _own_tables(module: torch.nn.Module):
    """(name, parameter) of every table a model marked with `shard_rows`."""
    for n, p in module.named_parameters():
        if getattr(p, _MARK, False):
            yield n, p


def param_partition_specs(module: torch.nn.Module) -> Dict[str, tuple]:
    """{parameter name: spec}: `SHARDED_SPEC` for a row-sharded
    `FeatureEmbedding` table and for a model's own table marked with
    `shard_rows` (flax's partition metadata, name for name), ``()``
    (replicated) for every other."""
    sharded = {_table_param_name(mname, t)
               for mname, m in _feature_embeddings(module)
               for t in m.tables if m.table_sharded(t)}
    sharded |= {n for n, _ in _own_tables(module)}
    return {n: (SHARDED_SPEC if n in sharded else ())
            for n, _ in module.named_parameters()}


def replicate_specs(tree: Mapping[str, Any]) -> Dict[str, tuple]:
    return {k: () for k in tree}


@torch.no_grad()
def shard_params(module_or_params, mesh, specs: Optional[Mapping] = None):
    """Row-shard every parameter whose spec is `SHARDED_SPEC`.

    A module: each such `FeatureEmbedding` table keeps this rank's padded
    shard in place (the same Parameter) and its module records the
    `RowShard`, so its lookups run the exchange; so does each table the
    model marked with `shard_rows`, the Parameter itself carrying its
    `RowShard` (`row_shard`; a table sharded once is left as it is),
    and the module records the mesh (`module_mesh`); returns the module. A
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
        for n, p in _own_tables(module):
            if specs.get(n) != SHARDED_SPEC or hasattr(p, _SHARD):
                continue
            shard = row_bounds(p.shape[0], mesh)
            p.data = local_rows(p.data, mesh)
            setattr(p, _SHARD, shard)
        _MODULE_MESH[module] = mesh
        return module
    specs = specs or {}
    return {k: (local_rows(v, mesh) if specs.get(k) == SHARDED_SPEC else v)
            for k, v in module_or_params.items()}


def table_shards(module: torch.nn.Module) -> Dict[str, RowShard]:
    """{parameter name: RowShard} of the module's row-sharded tables (its
    `FeatureEmbedding` tables and its own)."""
    out = {_table_param_name(mname, t): shard
           for mname, m in _feature_embeddings(module)
           for t, shard in m.table_shards.items()}
    out.update({n: getattr(p, _SHARD) for n, p in _own_tables(module)
                if hasattr(p, _SHARD)})
    return out


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
