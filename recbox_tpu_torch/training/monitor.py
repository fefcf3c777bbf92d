"""Early-stop monitor: a weighted sum of metrics and patience bookkeeping.

Own copy of `recbox_tpu/training/monitor.py`: the monitored value is a
weighted sum of metrics (e.g. ``{"AUC": 1, "logloss": -1}``); a value
better than the best so far by more than ``min_delta`` is an improvement,
anything else a plateau, and ``patience`` plateaus in a row stop the run.
A mode other than 'max' / 'min' raises ValueError (the JAX copy asserts).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, kv: Union[str, Mapping[str, float]], mode: str = "max",
                 patience: int = 2, min_delta: float = 1e-6):
        if isinstance(kv, str):
            kv = {kv: 1.0}
        self.kv = dict(kv)
        if mode not in ("max", "min"):
            raise ValueError(f"monitor mode {mode!r}; expected 'max' or 'min'")
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best_value = float("-inf") if mode == "max" else float("inf")
        self.best_epoch = -1
        self.stopping_steps = 0

    def get_value(self, metrics: Dict[str, float]) -> float:
        value = 0.0
        for k, w in self.kv.items():
            if k not in metrics:
                raise KeyError(f"monitor metric {k!r} missing from "
                               f"{list(metrics)}")
            value += w * metrics[k]
        return value

    def update(self, metrics: Dict[str, float], epoch: int):
        """Returns (value, improved, should_stop)."""
        value = self.get_value(metrics)
        if self.mode == "max":
            improved = value > self.best_value + self.min_delta
        else:
            improved = value < self.best_value - self.min_delta
        if improved:
            self.best_value = value
            self.best_epoch = epoch
            self.stopping_steps = 0
        else:
            self.stopping_steps += 1
        return value, improved, self.stopping_steps >= self.patience

    def state(self) -> dict:
        return {"best_value": self.best_value, "best_epoch": self.best_epoch,
                "stopping_steps": self.stopping_steps}

    def restore(self, st: dict) -> None:
        self.best_value = st["best_value"]
        self.best_epoch = st["best_epoch"]
        self.stopping_steps = st["stopping_steps"]
