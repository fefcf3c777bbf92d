"""Checkpoint save / load of a trainer's state dict.

Counterpart of `recbox_tpu/training/checkpoint.py`: `save_checkpoint` /
`load_checkpoint` (:19-49) over `torch.save` / `torch.load`: the state
({params, opt_state, step, epoch, monitor}, and the packed trainer's packs
and embedding lr) is written to ``path + '.tmp'``, flushed and fsynced,
renamed over ``path``, and the directory fsynced, so a preempted host never
leaves a torn file. Under several processes only rank 0 writes (JAX
:19-30); a mesh trainer's `state_dict` has gathered its row-sharded tables
whole first, on every rank. Loading reads tensors, containers and numbers
only (``weights_only=True``), onto ``map_location``.

`OrbaxCheckpointer` (JAX :52-130, its public name kept) is the
asynchronous, sharded one, over `torch.distributed.checkpoint`'s
``async_save`` / ``load``: the tensors of a state (a trainer's
``state_dict(sharded=True)``, whose row shards are DTensors) go to a
directory, each rank writing its own shards, while training goes on; the
numbers (step, epoch, emb_lr, ...) go to a JSON file that is staged and
committed only once the tensors are durable, at `wait` or at the next
`save`, as JAX's ``_pending_meta``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

__all__ = ["save_checkpoint", "load_checkpoint", "OrbaxCheckpointer"]


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(path: str, state: dict) -> None:
    if not _is_rank0():
        # only rank 0 writes: every rank would otherwise race on one file
        # (the state is whole on every rank)
        return
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        torch.save(state, fh)
        fh.flush()
        os.fsync(fh.fileno())   # the data is durable before the rename
    os.replace(tmp, path)
    # and so is the rename itself (the directory entry)
    dfd = os.open(dirname, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def load_checkpoint(path: str, map_location: Optional[
        Union[str, torch.device]] = None) -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def _split(state: dict):
    """(the tensors, nested, for `torch.distributed.checkpoint`; the
    top-level numbers, strings and None for the JSON file)."""
    arrays, meta = {}, {}
    for k, v in state.items():
        if isinstance(v, (int, float, str)) or v is None:
            meta[k] = v
        else:
            arrays[k] = v
    return arrays, meta


class OrbaxCheckpointer:
    """Asynchronous, sharded checkpoints over `torch.distributed.checkpoint`:

        ckpt = OrbaxCheckpointer()
        ckpt.save(dir_path, trainer.state_dict(sharded=True))  # returns
        ckpt.wait()                                 # durable, meta committed
        state = ckpt.load(dir_path, trainer.state_dict(sharded=True))
        trainer.load_state_dict(state)

    Every rank calls each method. ``load`` fills ``template``'s tensors in
    place (its DTensors take this rank's rows) and returns it with the
    saved numbers."""

    def __init__(self):
        self._future = None
        self._group = None
        # meta JSON staged per save, committed once the matching tensors
        # are durable: a crash mid-flight must not pair new step/epoch
        # meta with the previous (or no) tensors
        self._pending_meta = None          # (tmp_path, final_path)

    def _commit_pending_meta(self) -> None:
        if self._pending_meta is not None:
            tmp, final = self._pending_meta
            self._pending_meta = None
            if os.path.exists(tmp):
                os.replace(tmp, final)

    def _finish(self) -> None:
        if self._future is not None:
            self._future.result()
            self._future = None

    def save(self, directory: str, state: dict) -> None:
        import torch.distributed.checkpoint as dcp
        directory = os.path.abspath(directory)
        arrays, meta = _split(state)
        # the previous save is durable once its future resolves: commit its
        # meta before this one starts
        self._finish()
        self._commit_pending_meta()
        kwargs = {}
        if dist.is_initialized():
            # the writer's thread runs collectives of its own while the
            # training steps run theirs: a gloo group of the same ranks of
            # its own carries them (host-side, as the writer stages)
            if self._group is None:
                self._group = dist.new_group(backend="gloo")
            kwargs["process_group"] = self._group
        self._future = dcp.async_save(
            arrays, storage_writer=dcp.FileSystemWriter(directory), **kwargs)
        if _is_rank0():
            os.makedirs(directory + ".meta", exist_ok=True)
            tmp = directory + ".meta/state.json.tmp"
            with open(tmp, "w") as fh:
                json.dump(meta, fh)
            # staged, NOT committed: the tensors are still in flight
            self._pending_meta = (tmp, directory + ".meta/state.json")

    def wait(self) -> None:
        self._finish()
        self._commit_pending_meta()
        if dist.is_initialized() and dist.get_world_size() > 1:
            from recbox_tpu_torch.parallel.mesh import barrier
            barrier()

    def load(self, directory: str, template: dict) -> dict:
        """The saved state in ``template``'s structure. A same-process
        save → load waits for the save and its meta first; without a
        committed meta the template's numbers stand (a staged meta may
        belong to tensors that never landed)."""
        import torch.distributed.checkpoint as dcp
        self.wait()
        directory = os.path.abspath(directory)
        arrays, meta_t = _split(template)
        dcp.load(arrays, storage_reader=dcp.FileSystemReader(directory),
                 process_group=self._group)
        out = dict(arrays)
        meta_path = directory + ".meta/state.json"
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                out.update(json.load(fh))
        else:
            out.update(meta_t)
        return out

    def close(self) -> None:
        self.wait()
