"""S3Rec's pretraining phase: the pretrain batches, the pretrainer and the
graft onto a fine-tune model.

Counterpart of `recbox_tpu/training/pretrain.py`:

* `reconstruct_pretrain_batch` (:39) — the masked-item and segment
  instances of a batch of histories in one vectorized numpy pass with
  fixed (B, L) shapes; a copy of JAX's function, so the same
  ``np.random.Generator`` state draws the same masks, negatives and
  segments, value for value.
* `S3RecPretrainer` (:147) — optimizes `S3Rec.pretrain_losses` (AAP +
  MIP + MAP + SP) with Adam (optax's, no clipping) over the model's
  `PRETRAIN_PARAMETERS`, in training mode (dropout from a generator seeded
  with ``seed``), and writes an atomic checkpoint an epoch under
  ``workdir``; the epoch order and the batches' draws come from
  ``np.random.default_rng(seed)``, as in JAX.
* `transfer_pretrained` (:133) — the pretrained parameters grafted by name
  onto a fine-tune model's state dict; the names the pretrain phase has
  not (the causal encoder, its positions) keep their fresh draw, as JAX's
  graft by subtree does.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from recbox_tpu_torch.models.sequential.pretrain import PRETRAIN_PARAMETERS
from recbox_tpu_torch.nn.core import set_dropout_generator
from recbox_tpu_torch.training.checkpoint import save_checkpoint
from recbox_tpu_torch.training.trainer import _Adam

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["reconstruct_pretrain_batch", "S3RecPretrainer",
           "transfer_pretrained"]


def reconstruct_pretrain_batch(item_seq: np.ndarray, seq_len: np.ndarray,
                               n_items: int, mask_token: int,
                               rng: np.random.Generator,
                               mask_ratio: float = 0.2,
                               attribute_table: Optional[np.ndarray] = None,
                               neg_tries: int = 8) -> Dict[str, np.ndarray]:
    """S3Rec's pretrain instances of right-padded histories.

    ``item_seq`` (B, L) right-padded ids (0 = PAD), ``seq_len`` (B,);
    ``n_items`` the vocabulary (ids 1 .. n_items − 1 are items);
    ``mask_token`` the [MASK] id; each valid position is masked with
    probability ``mask_ratio``; a masked position's negative is the first
    of ``neg_tries`` uniform draws that is not in its row (the last draw
    if none is); a segment of length in [1, len // 2] is masked for SP and
    its negative is a window of the batch's concatenated histories.
    ``attribute_table`` (n_items[+1], A) multi-hot adds each position's
    attribute targets. Returns left-padded (B, L) int32 arrays
    masked_seq, pos_items, neg_items, masked_segment, pos_segment,
    neg_segment, seq_len (B,) and, with a table, attributes (B, L, A).
    """
    item_seq = np.asarray(item_seq)
    seq_len = np.asarray(seq_len).astype(np.int32)
    b, length = item_seq.shape
    j = np.arange(length)[None, :]
    valid = j < seq_len[:, None]

    mask_draw = (rng.random((b, length)) < mask_ratio) & valid
    masked_seq = np.where(mask_draw, mask_token, item_seq)
    pos_items = item_seq.copy()
    cand = rng.integers(1, n_items, size=(b, length, neg_tries)).astype(
        np.int32)
    member = (cand[:, :, :, None] ==
              np.where(valid, item_seq, -1)[:, None, None, :]).any(-1)
    first_ok = np.argmax(~member, axis=-1)
    chosen = np.take_along_axis(cand, first_ok[..., None], axis=-1)[..., 0]
    neg_items = np.where(mask_draw, chosen, item_seq).astype(np.int32)

    ln = seq_len.astype(np.int64)
    can_segment = ln >= 2
    max_s = np.maximum(ln // 2, 1)
    s = 1 + (rng.random(b) * max_s).astype(np.int64)
    s = np.minimum(s, max_s)
    start = (rng.random(b) * (ln - s + 1)).astype(np.int64)
    in_seg = (j >= start[:, None]) & (j < (start + s)[:, None]) & valid \
        & can_segment[:, None]
    masked_segment = np.where(in_seg, mask_token, item_seq)
    pos_segment = np.where(
        in_seg, item_seq,
        np.where(valid & can_segment[:, None], mask_token, item_seq))
    flat = item_seq[valid]
    total = len(flat)
    neg_start = (rng.random(b) * np.maximum(total - s, 1)).astype(np.int64)
    neg_idx = np.clip(neg_start[:, None] + (j - start[:, None]), 0,
                      total - 1)
    neg_fill = flat[neg_idx] if total else item_seq
    neg_segment = np.where(in_seg, neg_fill, pos_segment)

    out = {
        "masked_seq": _left_pad(masked_seq, seq_len),
        "pos_items": _left_pad(pos_items, seq_len),
        "neg_items": _left_pad(neg_items, seq_len),
        "masked_segment": _left_pad(masked_segment, seq_len),
        "pos_segment": _left_pad(pos_segment, seq_len),
        "neg_segment": _left_pad(neg_segment, seq_len),
        "seq_len": seq_len,
    }
    if attribute_table is not None:
        # the targets follow the original item at each position
        out["attributes"] = np.asarray(attribute_table)[
            _left_pad(pos_items, seq_len)]
    return {k: v.astype(np.int32) if v.dtype.kind in "iu" else v
            for k, v in out.items()}


def _left_pad(arr: np.ndarray, seq_len: np.ndarray) -> np.ndarray:
    """Right-padded rows shifted so each valid run ends at the last
    column."""
    length = arr.shape[1]
    src = np.arange(length)[None, :] - (length - seq_len)[:, None]
    gathered = np.take_along_axis(arr, np.clip(src, 0, length - 1), axis=1)
    return np.where(src >= 0, gathered, 0)


def transfer_pretrained(init_state: Mapping[str, torch.Tensor],
                        pretrained: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """``init_state`` (a fine-tune model's state dict) with every entry the
    pretrained dict has replaced by the pretrained tensor; load the result
    with ``model.load_state_dict``."""
    out = {}
    for name, value in init_state.items():
        new = pretrained.get(name)
        out[name] = value if new is None else new.to(value.device,
                                                     value.dtype)
    return out


class S3RecPretrainer:
    """Phase 1: Adam on the joint AAP + MIP + MAP + SP loss of ``model``
    (an `S3Rec`, trained in place).

    Usage::

        pre = S3RecPretrainer(model, mask_ratio=0.2)
        params = pre.pretrain(item_seq, seq_len, epochs=..., batch_size=...)
        fine = S3Rec(...)             # or the same model
        fine.load_state_dict(transfer_pretrained(fine.state_dict(), params))
        Trainer(fine, loss, cfg, train_method="full_scores").fit(...)
    """

    def __init__(self, model, learning_rate: float = 1e-3,
                 weights=(0.2, 1.0, 1.0, 0.5), mask_ratio: float = 0.2,
                 attribute_table: Optional[np.ndarray] = None,
                 seed: int = 2024, workdir: Optional[str] = None):
        self.model = model
        self.weights = tuple(weights)
        self.mask_ratio = mask_ratio
        self.attribute_table = attribute_table
        self.workdir = workdir
        self.device = next(model.parameters()).device
        self.params = {n: p for n, p in model.named_parameters()
                       if n.startswith(PRETRAIN_PARAMETERS)}
        self._opt = _Adam(list(self.params.values()), learning_rate, None)
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        set_dropout_generator(model, self.dropout_generator)
        self._np_rng = np.random.default_rng(seed)
        self.epoch_losses = []

    def step(self, batch: Mapping[str, np.ndarray]) -> torch.Tensor:
        """One Adam step on a reconstructed batch; the loss (a device
        scalar)."""
        self.model.train()
        dbatch = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                  for k, v in batch.items()}
        loss = self.model.pretrain_losses(dbatch, weights=self.weights)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names])
        self._opt.step(list(grads))
        return loss.detach()

    def pretrain(self, item_seq: np.ndarray, seq_len: np.ndarray,
                 epochs: int = 1, batch_size: int = 256
                 ) -> Dict[str, torch.Tensor]:
        """Run the pretrain phase over full batches (the batch shrinks to
        the data when there is less than one); returns the pretrained
        parameters by name (detached copies)."""
        fm = self.model.feature_map
        n_items = fm[fm.corpus_index].vocab_size
        item_seq, seq_len = np.asarray(item_seq), np.asarray(seq_len)
        n = len(item_seq)
        if n == 0:
            raise ValueError("pretrain() needs at least one sequence")
        batch_size = min(batch_size, n)
        for epoch in range(epochs):
            order = self._np_rng.permutation(n)
            losses = []
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                batch = reconstruct_pretrain_batch(
                    item_seq[idx], seq_len[idx], n_items, n_items,
                    self._np_rng, self.mask_ratio, self.attribute_table)
                losses.append(self.step(batch))
            mean = float(torch.stack(losses).mean()) if losses \
                else float("nan")
            self.epoch_losses.append(mean)
            logger.info("s3rec pretrain epoch %d: loss %.4f", epoch, mean)
            if self.workdir:
                save_checkpoint(f"{self.workdir}/pretrain-{epoch}.ckpt",
                                {"params": self.pretrained(),
                                 "epoch": epoch})
        return self.pretrained()

    def pretrained(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.params.items()}
