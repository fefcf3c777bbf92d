"""Checkpoint save / load of a trainer's state dict.

Counterpart of `recbox_tpu/training/checkpoint.py` `save_checkpoint` /
`load_checkpoint` (:19-49) over `torch.save` / `torch.load`: the state
({params, opt_state, step, epoch, monitor}, and the packed trainer's packs
and embedding lr) is written to ``path + '.tmp'``, flushed and fsynced,
renamed over ``path``, and the directory fsynced, so a preempted host never
leaves a torn file. Loading reads tensors, containers and numbers only
(``weights_only=True``), onto ``map_location``. The asynchronous, sharded
`OrbaxCheckpointer` waits for the mesh (`ROADMAP.md`, Queue A: parallel/).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, state: dict) -> None:
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
