"""Stage evaluators: callables plugged into `Trainer` as ``eval_fn``.

Counterpart of `recbox_tpu/evaluation/evaluators.py`:

* `RetrievalEvaluator`: every query and the whole corpus through the
  model's towers (`encode_user` / `encode_item`) in fixed-shape batches on
  the trainer's device, then `evaluate_retrieval`'s full sort. Only the
  'full' protocol: the sampled protocols ('uniN' / 'popN') wait for
  `evaluation/candidate.py` and the beyond-accuracy metrics for
  `evaluation/beyond_accuracy.py` (`ROADMAP.md`, Queue A: slice 5, matching
  training, and the rest of evaluation); asking for either raises
  NotImplementedError.
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
from recbox_tpu_torch.evaluation.ctr import evaluate_ctr
from recbox_tpu_torch.evaluation.retrieval import evaluate_retrieval

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
        protocol: str = "full",
        exclude_items: Sequence[int] = (),
    ):
        if protocol != "full":
            raise NotImplementedError(
                f"protocol={protocol!r}: the sampled protocols are not "
                "ported yet (ROADMAP.md, Queue A: slice 5, "
                "evaluation/candidate.py); protocol='full' is")
        if beyond_accuracy_metrics:
            raise NotImplementedError(
                "beyond-accuracy metrics are not ported yet (ROADMAP.md, "
                "Queue A: the rest of evaluation, "
                "evaluation/beyond_accuracy.py)")
        self.user_loader = ArrayLoader(user_arrays, batch_size=batch_size,
                                       shuffle=False)
        self.corpus_loader = ArrayLoader(corpus_arrays, batch_size=batch_size,
                                         shuffle=False)
        self.query_indices = np.asarray(query_indices)
        self.train_user2items = train_user2items
        self.valid_user2items = valid_user2items
        self.metrics = list(metrics)
        self.protocol = protocol
        # catalog rows that are not real items (e.g. a PAD row 0): masked
        # for every user
        self.exclude_items = tuple(exclude_items)

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

    def __call__(self, trainer) -> Dict[str, float]:
        user_embs, item_embs = self.encode_all(trainer)
        self.last_sample_count = float(len(self.query_indices))
        return evaluate_retrieval(
            user_embs, item_embs, self.train_user2items,
            self.valid_user2items, self.query_indices, self.metrics,
            exclude_items=self.exclude_items, device=trainer.device)


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
