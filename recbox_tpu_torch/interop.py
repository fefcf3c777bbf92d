"""Move the state of the JAX package onto the port.

`from_jax_params` maps a flax parameter tree onto a port module;
`load_packed_state` moves a JAX `PackedEmbeddingTrainer`'s dense params,
packs and split accumulators into the port's, in each of its layouts, so
both packages then compute the same step. The
caller unboxes flax's `Partitioned` leaves and converts them to numpy on
the JAX side (``jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))``);
this module imports neither JAX nor flax. Each flax param has a list of
candidate port keys, and the first one the port module has is taken:

  .../emb_<table>          →  .../tables.<table>     (FeatureEmbedding),
                              else .../emb_<table>   (a bare table, e.g.
                                                      SASRec's emb_item)
  .../num_<feature>        →  .../numeric.<feature>  (FeatureEmbedding)
  .../Dense_<i>/kernel     →  .../dense.<i>.weight   (MLP), else
                              .../Dense_<i>.weight   (a Linear of that name)
  .../<m>/kernel (D, O)    →  .../<m>.weight, transposed (flax (in, out),
                                                      torch (out, in)): the
                                                      o<i> projections
  .../<m>/kernel (D, H, K) →  .../<m>.weight (H·K, D): DenseGeneral's
                                                      q<i>/k<i>/v<i> as one
                                                      Linear, reshaped to
                                                      (D, H·K), transposed
  .../<m>/kernel (kh, kw, I, O) → .../<m>.weight (O, I, kh, kw): a Conv
  .../<m>/kernel (k, I, O)  →  .../<m>.weight (O, I, k) where the port's
                                                      weight is 3-D: a 1-D
                                                      Conv
  .../<m>/bias (H, K)      →  .../<m>.bias (H·K,)    (DenseGeneral's bias)
  .../Dense_<i>/bias       →  .../dense.<i>.bias, else .../Dense_<i>.bias
  .../BatchNorm_<i>/<leaf> →  .../bn.<i>.<leaf>     (MLP; scale, bias and,
                                                      from ``batch_stats``,
                                                      mean and var), else
                                                      .../BatchNorm_<i>.<leaf>
  any other a/b/c          →  a.b.c, same layout     (e.g. DeepFM's lr/bias,
                                                      lr_bias, dnn_w1 (F, D,
                                                      H), dnn_b1; LayerNorm's
                                                      scale and bias, which
                                                      the port names alike;
                                                      the crosses' w<i>,
                                                      U<l>, the CIN's w<i>
                                                      (h, m, F), kept in
                                                      flax's layout)

The flax variables' ``batch_stats`` collection (BatchNorm running mean and
variance) maps by the same rules onto the port's buffers of those names.

The sequential zoo takes the same rules: Caser's NHWC kernels (h, D, 1,
n_h) / (L, 1, 1, n_v) become `Conv2d` weights (n_h, 1, h, D) / (n_v, 1,
L, 1), NextItNet's (k, D, D) `Conv1d` weights (D, D, k); a flax
``GRUCell``'s ``ir`` / ``iz`` / ``in`` / ``hr`` / ``hz`` / ``hn`` Denses
(``GRUCell_<i>`` where ``nn.RNN`` scans it, ``gru`` in the GGNN) map onto
`nn.recurrent.GRUCell`'s Linears of those names; BERT4Rec's (V + 1)-row
``emb_item``, SINE's ``prototypes`` and LightSANs' ``pos`` are bare
parameters; LightSANs' DenseGeneral heads (``q``, ``k``, ``v``,
``theta``, ``pq``, ``pk``) are one Linear each
(`tests/test_torch_sequential_zoo.py`).

The ranking zoo's remainder takes them too: an MLP's ``Dice_<j>``
(``alpha``, and its ``BatchNorm_0`` statistics from ``batch_stats``)
becomes the MLP's ``dice.<j>``; the multitask experts' ``w<i>`` (E, in,
out) / ``b<i>`` (E, out), the field-aware tables (``ffm_embedding``, a
FeatureEmbedding F·D wide), the pair kernels, DAGFM's ``w<l>`` /
``p<l>`` / ``q<l>`` and EulerNet's orders keep flax's layout; DIEN's
``gru1`` / ``augru`` cells sit under ``cell`` as in ``nn.RNN``, DSIN's two
cells are ``GRUCell_0`` / ``GRUCell_1``; CCPM's 1-D and FGCNN's 2-D
convolutions take the Conv rules above; S3Rec's (V + 1)-row ``emb_item``
and GRU4RecF's ``emb_feat`` are bare tables
(`tests/test_torch_sequence_ctr.py`, `tests/test_torch_ctr_extended.py`,
`tests/test_torch_multitask.py`, `tests/test_torch_pretrain.py`).

The RL rerankers of `models/reranking/rl.py` take them with no rule of
their own: ``proj``, ``score``, ``value`` and PPO's bias-free ``att_c`` /
``att_h`` / ``att_v`` are Dense kernels; the cells ``nn.RNN`` scans are
``GRUCell_0`` / ``GRUCell_1`` in the model's scope (the EGR models' forward
and backward ones), PPO's decoder cell is ``cell``; the discriminator's
``head`` is an MLP (`tests/test_torch_rl_rerank.py`).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["from_jax_params", "load_packed_state"]

_DENSE = re.compile(r"Dense_(\d+)$")
_DICE = re.compile(r"Dice_(\d+)$")
_NORM = re.compile(r"BatchNorm_(\d+)$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _kernel(arr: np.ndarray, port_ndim: int = 2) -> np.ndarray:
    """A flax kernel as the torch weight: Dense (in, out) and DenseGeneral
    (in, H, K) as (out, in); Conv (kh, kw, in, out) as (out, in, kh, kw)
    and a 1-D Conv (k, in, out) as (out, in, k), the port's weight being
    4-D or 3-D."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 3 and port_ndim == 3:
        return arr.transpose(2, 1, 0)
    return arr.reshape(arr.shape[0], -1).T


def _candidates(path: Tuple[str, ...], arr: np.ndarray
                ) -> List[Tuple[str, Optional[Callable]]]:
    """(state_dict key, transform) candidates for one flax param path, in
    order of preference."""
    # an MLP's Dice_<j> is its dice[j] (its alpha and, from batch_stats,
    # its BatchNorm_0's statistics)
    path = tuple(p for part in path for p in (
        ("dice", _DICE.match(part).group(1)) if _DICE.match(part)
        else (part,)))
    *mods, leaf = path
    out: List[Tuple[List[str], Optional[Callable]]] = []
    if leaf.startswith("emb_"):
        out.append((mods + ["tables", leaf[4:]], None))
    if leaf.startswith("num_"):
        out.append((mods + ["numeric", leaf[4:]], None))
    dense = _DENSE.match(mods[-1]) if mods else None
    if dense and leaf in ("kernel", "bias"):
        out.append((mods[:-1] + ["dense", dense.group(1),
                                 "weight" if leaf == "kernel" else "bias"],
                    _kernel if leaf == "kernel" else None))
    norm = _NORM.match(mods[-1]) if mods else None
    if norm:
        out.append((mods[:-1] + ["bn", norm.group(1), leaf], None))
    if leaf == "kernel" and mods:
        out.append((mods + ["weight"], _kernel))
    if leaf == "bias" and mods and arr.ndim == 2:
        out.append((mods + ["bias"], lambda a: a.reshape(-1)))
    out.append((list(path), None))
    return [(".".join(k), f) for k, f in out]


def from_jax_params(params: Mapping, model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """A `state_dict` for ``model`` from a flax param tree of numpy arrays.

    ``params`` may be the flax variables dict (with a top-level "params",
    and "batch_stats" where the model has BatchNorms) or the params tree
    itself. Raises KeyError on a flax param with no
    counterpart, on a port parameter no flax param fills, and ValueError on
    a shape mismatch. Load the result with ``model.load_state_dict``.
    """
    stats: Mapping = {}
    if "params" in params and isinstance(params["params"], Mapping):
        stats = params.get("batch_stats", {})
        params = params["params"]
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, value in list(_flatten(params)) + list(_flatten(stats)):
        arr = np.asarray(value)
        cands = _candidates(path, arr)
        found = [(k, f) for k, f in cands if k in target]
        if not found:
            raise KeyError(f"flax param {'/'.join(path)} has no counterpart "
                           f"in the port: it maps to one of "
                           f"{[k for k, _ in cands]}, which the port module "
                           "does not have")
        key, transform = found[0]
        ref = target[key]
        if transform is _kernel:
            arr = _kernel(arr, ref.ndim)
        elif transform is not None:
            arr = transform(arr)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {arr.shape} vs port "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(arr, copy=True)).to(
            dtype=ref.dtype, device=ref.device)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port parameters (or buffers: BatchNorm statistics "
                       f"come from the variables' batch_stats) without a "
                       f"flax counterpart: {missing}")
    return out


def load_packed_state(trainer, dense_params: Mapping,
                      packs: Mapping[str, np.ndarray],
                      model_state: Optional[Mapping] = None,
                      accs: Optional[Mapping[str, np.ndarray]] = None
                      ) -> None:
    """Put a JAX `PackedEmbeddingTrainer`'s state into an initialized port
    trainer: its dense params tree (``t.params``, numpy leaves) onto the
    model, its packs (``t.packs``, numpy, same names and layout: AdaGrad
    state in the row, values alone, or lazy Adam's [values | m | v]) into
    ``trainer.packs``, its split accumulators (``t.accs``, (ΣV, slots) a
    split-layout pack) into ``trainer.accs``; its ``model_state`` (the
    variables beside ``params``, e.g. ``{"batch_stats": ...}``: BatchNorm
    and Dice statistics) onto the model's buffers. Raises on a missing or
    extra pack or accumulator tensor, or a shape mismatch. The dense Adam's
    moments stay at the port trainer's (zeros after init)."""
    model = trainer.model
    model.load_state_dict(from_jax_params(
        {"params": dense_params, **(model_state or {})}, model))
    for what, src, dst in (("packs", packs, trainer.packs),
                           ("accs", accs or {}, trainer.accs)):
        if set(src) != set(dst):
            raise KeyError(f"JAX {what} {sorted(src)} vs port {what} "
                           f"{sorted(dst)}")
        for name, arr in src.items():
            ref = dst[name]
            if tuple(np.shape(arr)) != tuple(ref.shape):
                raise ValueError(f"{what} {name}: JAX shape "
                                 f"{np.shape(arr)} vs port "
                                 f"{tuple(ref.shape)}")
            with torch.no_grad():
                ref.copy_(torch.from_numpy(np.array(arr, np.float32)))
