"""Move the state of the JAX package onto the port.

`from_jax_params` maps a flax parameter tree onto a port module;
`load_packed_state` moves a JAX `PackedEmbeddingTrainer`'s dense params and
packs into the port's, so both packages then compute the same step. The
caller unboxes flax's `Partitioned` leaves and converts them to numpy on
the JAX side (``jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))``);
this module imports neither JAX nor flax. The mapping:

  .../emb_<table>          →  .../tables.<table>     (FeatureEmbedding)
  .../num_<feature>        →  .../numeric.<feature>  (FeatureEmbedding)
  .../Dense_<i>/kernel     →  .../dense.<i>.weight   (MLP, transposed:
                                                      flax (in, out), torch
                                                      (out, in))
  .../Dense_<i>/bias       →  .../dense.<i>.bias
  any other a/b/c          →  a.b.c, same layout     (e.g. DeepFM's lr/bias,
                                                      lr_bias, dnn_w1 (F, D,
                                                      H), dnn_b1)
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["from_jax_params", "load_packed_state"]

_DENSE = re.compile(r"Dense_(\d+)$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(state_dict key, transpose?) for one flax param path."""
    *mods, leaf = path
    if leaf.startswith("emb_"):
        return ".".join(mods + ["tables", leaf[4:]]), False
    if leaf.startswith("num_"):
        return ".".join(mods + ["numeric", leaf[4:]]), False
    dense = _DENSE.match(mods[-1]) if mods else None
    if dense and leaf in ("kernel", "bias"):
        key = ".".join(mods[:-1] + ["dense", dense.group(1),
                                    "weight" if leaf == "kernel" else "bias"])
        return key, leaf == "kernel"
    return ".".join(path), False


def from_jax_params(params: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """A `state_dict` for ``model`` from a flax param tree of numpy arrays.

    ``params`` may be the flax variables dict (with a top-level "params")
    or the params tree itself. Raises KeyError on a flax param with no
    counterpart, on a port parameter no flax param fills, and ValueError on
    a shape mismatch. Load the result with ``model.load_state_dict``.
    """
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        key, transpose = _torch_key(path)
        if key not in target:
            raise KeyError(f"flax param {'/'.join(path)} has no counterpart "
                           f"in the port: it maps to {key!r}, which the port "
                           "module does not have")
        arr = np.asarray(value)
        if transpose:
            arr = arr.T
        ref = target[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {arr.shape} vs port "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(arr, copy=True)).to(
            dtype=ref.dtype, device=ref.device)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port parameters without a flax counterpart: "
                       f"{missing}")
    return out


def load_packed_state(trainer, dense_params: Mapping,
                      packs: Mapping[str, np.ndarray]) -> None:
    """Put a JAX `PackedEmbeddingTrainer`'s state into an initialized port
    trainer: its dense params tree (``t.params``, numpy leaves) onto the
    model, its packs (``t.packs``, numpy, same names and layout) into
    ``trainer.packs``. Raises on a missing or extra pack or a shape
    mismatch. Adam's moments stay at the port trainer's (zeros after
    init)."""
    model = trainer.model
    model.load_state_dict(from_jax_params(dense_params, model))
    if set(packs) != set(trainer.packs):
        raise KeyError(f"JAX packs {sorted(packs)} vs port packs "
                       f"{sorted(trainer.packs)}")
    for name, arr in packs.items():
        ref = trainer.packs[name]
        if tuple(np.shape(arr)) != tuple(ref.shape):
            raise ValueError(f"pack {name}: JAX shape {np.shape(arr)} vs "
                             f"port {tuple(ref.shape)}")
        with torch.no_grad():
            ref.copy_(torch.from_numpy(np.array(arr, np.float32)))
