"""Logging + experiment tracking + profiling hooks.

Own copy of `recbox_tpu/utils/logging.py`; `profile_step` records a
`torch.profiler` trace (CPU and CUDA activities) where JAX's records a
`jax.profiler` one (`ROADMAP.md` Queue C).

Covers the reference's observability surface (SURVEY §5.1/§5.5):
  - `set_logger`: file+stream logging with process id
    (`recbox/ranking/utils.py:69-83`, recbole `utils/logger.py:60`);
  - `MetricsWriter`: scalar tracking to JSONL + optional TensorBoard
    (recbole `get_tensorboard` `utils/utils.py:208-233` / WandbLogger
    `utils/wandblogger.py:12-60` — backend-pluggable, no hard deps);
  - `profile_step`: torch.profiler trace context for the device timeline —
    first-class here, absent in the reference.
"""

from __future__ import annotations

import contextlib
import json
import math
import logging
import os
import sys
import time
from typing import Dict, Optional

__all__ = ["set_logger", "MetricsWriter", "profile_step", "WandbLogger"]


def set_logger(log_file: Optional[str] = None, level: int = logging.INFO,
               name: str = "recbox_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    for h in logger.handlers:   # close before dropping: reconfiguring in
        h.close()                # a sweep leaked one fd per run
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s P%(process)d %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Scalar logger: JSONL always; TensorBoard if torch is importable."""

    def __init__(self, log_dir: str, tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:  # tensorboard optional
                logging.getLogger("recbox_tpu_torch").warning(
                    "tensorboard unavailable; JSONL only")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time(), **{
            k: float(v) for k, v in metrics.items()}}
        # NaN/Infinity are invalid JSON — sanitize so strict JSONL
        # consumers (pandas, jq) can read the whole file
        rec = {k: (None if isinstance(v, float) and not math.isfinite(v)
                   else v) for k, v in rec.items()}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_step(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace around a block (CPU and, where a
    card is present, CUDA activities) and write it under ``log_dir`` as a
    Chrome trace, ``trace.json`` (TensorBoard's and Perfetto's format),
    which holds the port's spans and a replayed step's phase markers
    (`utils/tracing.py`). No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class WandbLogger:
    """Weights & Biases hook (reference: `recbole/utils/wandblogger.py:12-60`):
    no-ops gracefully when wandb isn't installed or `enabled=False`, so the
    trainer can call it unconditionally."""

    def __init__(self, enabled: bool = False, project: str = "recbox_tpu_torch",
                 config: Optional[Dict] = None, **init_kw):
        self._run = None
        if not enabled:
            return
        try:
            import wandb  # optional dependency — absent in this image
            self._run = wandb.init(project=project, config=config or {},
                                   **init_kw)
        except Exception:
            logging.getLogger("recbox_tpu_torch").warning(
                "wandb unavailable; WandbLogger disabled")

    def log_metrics(self, metrics: Dict[str, float],
                    step: Optional[int] = None,
                    head: str = "train") -> None:
        if self._run is None:
            return
        tagged = {f"{head}/{k}": v for k, v in metrics.items()}
        self._run.log(tagged, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
