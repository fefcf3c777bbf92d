"""Stage evaluators: callables plugged into `Trainer` as ``eval_fn``.

Counterpart of `recbox_tpu/evaluation/evaluators.py`:

* `RetrievalEvaluator`: every query and the whole corpus through the
  model's towers (`encode_user` / `encode_item`) in fixed-shape batches on
  the trainer's device, then the 'full' protocol (`evaluate_retrieval`'s
  full sort) or a sampled one, 'uniN' / 'popN' (`evaluation/candidate.py`:
  the candidate matrix drawn once, at the first evaluation, from
  ``protocol_seed``, and reused by every later one); then, if asked, the
  beyond-accuracy metrics (`evaluation/beyond_accuracy.py`) over each
  user's top ``beyond_topk``: the full sort with the train items masked,
  or, under a sampled protocol, the candidate-ranked list.
  Under a mesh every rank encodes every query and the whole corpus: a
  row-sharded table's rows come through the lookup's exchange
  (n_data·V·D·4 bytes all-reduced an evaluation, the table in effect
  gathered whole), and the full sort runs as without a mesh, so it gives
  the unsharded evaluation's metrics.
* `CTREvaluator`: `Trainer.predict` over the validation rows, the sigmoid
  of the logits, then `evaluate_ctr` (AUC / logloss on the host, grouped
  metrics on the trainer's device).
* `MultiTaskEvaluator`: per-task metrics and their mean over tasks.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from recbox_tpu_torch.data.loader import MASK_KEY, ArrayLoader
from recbox_tpu_torch.evaluation.beyond_accuracy import (
    evaluate_beyond_accuracy,
)
from recbox_tpu_torch.evaluation.candidate import (
    candidate_topk, evaluate_candidate_retrieval, parse_protocol,
    sample_eval_candidates,
)
from recbox_tpu_torch.evaluation.ctr import evaluate_ctr
from recbox_tpu_torch.evaluation.retrieval import (
    _as_device, _pad_lists, evaluate_retrieval, full_sort_topk,
)

__all__ = ["RetrievalEvaluator", "CTREvaluator", "MultiTaskEvaluator"]


def _sigmoid(logits: np.ndarray) -> np.ndarray:
    return torch.sigmoid(torch.from_numpy(np.asarray(logits))).numpy()


class RetrievalEvaluator:
    def __init__(
        self,
        user_arrays: Dict[str, np.ndarray],
        corpus_arrays: Dict[str, np.ndarray],
        query_indices: np.ndarray,
        train_user2items: Mapping[int, Sequence[int]],
        valid_user2items: Mapping[int, Sequence[int]],
        metrics: Sequence[str] = ("Recall(k=20)", "NDCG(k=10)"),
        batch_size: int = 4096,
        beyond_accuracy_metrics: Sequence[str] = (),
        beyond_topk: int = 20,
        item_counts: Optional[np.ndarray] = None,
        item_categories: Optional[np.ndarray] = None,
        protocol: str = "full",
        protocol_seed: int = 2024,
        exclude_items: Sequence[int] = (),
    ):
        self.user_loader = ArrayLoader(user_arrays, batch_size=batch_size,
                                       shuffle=False)
        self.corpus_loader = ArrayLoader(corpus_arrays, batch_size=batch_size,
                                         shuffle=False)
        self.query_indices = np.asarray(query_indices)
        self.train_user2items = train_user2items
        self.valid_user2items = valid_user2items
        self.metrics = list(metrics)
        self.protocol = protocol
        self.protocol_seed = protocol_seed
        # catalog rows that are not real items (e.g. a PAD row 0): masked
        # in the full sort, never drawn as sampled negatives
        self.exclude_items = tuple(exclude_items)
        self._candidates = None
        if protocol != "full":
            parse_protocol(protocol)       # a bad spelling fails here
        # popularity counts default to the train interactions' counts
        self.beyond_accuracy_metrics = list(beyond_accuracy_metrics)
        self.beyond_topk = beyond_topk
        self.item_counts = item_counts
        # (num_items, num_categories) 0/1 matrix for Diversity
        self.item_categories = item_categories

    def encode_all(self, trainer):
        """(user embeddings, item embeddings) on the trainer's device, the
        loaders' tail pads dropped."""
        def run(loader, method):
            outs = []
            for batch in loader:
                mask = torch.from_numpy(batch.pop(MASK_KEY).astype(bool))
                emb = trainer.apply(batch, method=method)
                outs.append(emb[mask.to(emb.device)])
            return torch.cat(outs, dim=0)

        return (run(self.user_loader, "encode_user"),
                run(self.corpus_loader, "encode_item"))

    def _train_item_counts(self, num_items: int) -> np.ndarray:
        all_items = [np.asarray(l, np.int64)
                     for l in self.train_user2items.values() if len(l)]
        return np.bincount(
            np.concatenate(all_items) if all_items
            else np.zeros(0, np.int64), minlength=num_items)

    def __call__(self, trainer) -> Dict[str, float]:
        user_embs, item_embs = self.encode_all(trainer)
        dev = trainer.device
        num_items = item_embs.shape[0]
        self.last_sample_count = float(len(self.query_indices))
        if self.protocol == "full":
            out = evaluate_retrieval(
                user_embs, item_embs, self.train_user2items,
                self.valid_user2items, self.query_indices, self.metrics,
                exclude_items=self.exclude_items, device=dev)
        else:
            if self._candidates is None:
                dist, n_neg = parse_protocol(self.protocol)
                counts = self.item_counts
                if counts is None and dist == "popularity":
                    counts = self._train_item_counts(num_items)
                self._candidates = sample_eval_candidates(
                    self.query_indices, self.train_user2items,
                    self.valid_user2items, num_items, n_neg,
                    distribution=dist, item_counts=counts,
                    seed=self.protocol_seed,
                    exclude_items=self.exclude_items)
            cand_ids, cand_valid, true_padded = self._candidates
            out = evaluate_candidate_retrieval(
                user_embs, item_embs, cand_ids, cand_valid, true_padded,
                self.metrics, device=dev)
        if self.beyond_accuracy_metrics:
            if self.protocol != "full":
                # the recommendation set is the candidate-ranked list the
                # accuracy metrics rank
                cand_ids, cand_valid, _ = self._candidates
                topk_ids = candidate_topk(
                    user_embs, item_embs, _as_device(cand_ids, dev),
                    _as_device(cand_valid, dev),
                    self.beyond_topk).cpu().numpy()
            else:
                excl = list(self.exclude_items)
                train_padded = _pad_lists(
                    [list(self.train_user2items.get(q, ())) + excl
                     for q in self.query_indices], pad=num_items)
                # chunks of users: never the whole (U, I) score matrix
                topk_ids = np.concatenate([
                    full_sort_topk(user_embs[s:s + 1024], item_embs,
                                   self.beyond_topk,
                                   train_items=train_padded[s:s + 1024],
                                   device=dev)[1]
                    for s in range(0, len(user_embs), 1024)], axis=0)
            counts = self.item_counts
            if counts is None:
                counts = self._train_item_counts(num_items)
            out.update(evaluate_beyond_accuracy(
                topk_ids, num_items, item_counts=counts,
                metrics=self.beyond_accuracy_metrics,
                item_categories=self.item_categories))
        return out


class CTREvaluator:
    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        label: str,
        metrics: Sequence[str] = ("AUC", "logloss"),
        group_id: Optional[str] = None,
        batch_size: int = 4096,
        from_logits: bool = True,
    ):
        self.arrays = arrays
        self.label = label
        self.metrics = list(metrics)
        self.group_id = group_id
        self.loader = ArrayLoader(arrays, batch_size=batch_size,
                                  shuffle=False)
        self.from_logits = from_logits

    def __call__(self, trainer) -> Dict[str, float]:
        self.last_sample_count = float(len(self.arrays[self.label]))
        logits = trainer.predict(self.loader)
        probs = _sigmoid(logits) if self.from_logits else logits
        gid = self.arrays[self.group_id] if self.group_id else None
        return evaluate_ctr(self.arrays[self.label], probs, self.metrics,
                            group_id=gid, device=trainer.device)


class MultiTaskEvaluator:
    """Per-task metrics under the keys '<label>_<metric>', and their mean
    over the tasks under '<metric>' (the monitored one)."""

    def __init__(self, arrays, labels, metrics=("AUC", "logloss"),
                 batch_size: int = 4096, from_logits: bool = True):
        self.arrays = arrays
        self.labels = list(labels)
        self.metrics = list(metrics)
        self.loader = ArrayLoader(arrays, batch_size=batch_size,
                                  shuffle=False)
        self.from_logits = from_logits

    def __call__(self, trainer) -> Dict[str, float]:
        self.last_sample_count = float(len(self.arrays[self.labels[0]]))
        outputs = trainer.predict(self.loader)          # (N, T)
        if self.from_logits:
            outputs = _sigmoid(outputs)
        results = {}
        for metric in self.metrics:
            vals = []
            for t, label in enumerate(self.labels):
                out = evaluate_ctr(self.arrays[label], outputs[:, t],
                                   [metric], device=trainer.device)
                results[f"{label}_{metric}"] = out[metric]
                vals.append(out[metric])
            results[metric] = float(np.mean(vals))
        return results
