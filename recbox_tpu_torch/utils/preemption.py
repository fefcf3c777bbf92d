"""Preemption-safe training: checkpoint on SIGTERM/SIGINT and resume.

Own copy of `recbox_tpu/utils/preemption.py`: it polls the port's
`Trainer.stop_callback` (`training/trainer.py`, checked between steps in
`fit`) and refuses, in deferred mode, a trainer without one.

The reference has no failure/elastic story at all (SURVEY §5.3: no retry,
no health checks; recovery = rerun). Cloud VMs get a SIGTERM grace
window on preemption/maintenance; this module turns that into a durable
checkpoint so the re-exec'd job resumes from the preempted params instead
of the last eval-time save. Resume granularity: params/opt_state/rng are
exactly the preempted step's, but the data-loader position is not trainer
state — the interrupted epoch restarts from its first batch (batches seen
before the preemption are revisited with the newer params):

    guard = PreemptionGuard(trainer, workdir + "/preempt.ckpt")
    with guard:
        trainer.fit(loader)
    # on SIGTERM during fit: state saved, process exits 143; on restart:
    if guard.has_checkpoint():
        trainer.init(peek_batch); guard.restore()

The handler only sets a flag; the actual save runs on the main thread at
the next `should_stop()` poll (Trainer.fit polls between steps), so the
checkpoint is never written mid-step from a signal frame. If the grace
window is too short for a poll, the `save_on_signal=True` mode writes
immediately from the handler (safe for host-replicated state).
"""

from __future__ import annotations

import logging
import os
import signal
from typing import Optional

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that trigger a durable checkpoint.

    Args:
      trainer: any object with save(path)/load(path) (Trainer contract).
      path: checkpoint file for preemption saves.
      save_on_signal: write the checkpoint inside the signal handler
        (immediate; use when the preemption grace window is short, or when
        the signal may land outside the step loop — during eval or after
        fit() returns — where the deferred flag is never polled) instead
        of deferring to the next `should_stop()` poll.
      exit_code: process exit status after a handled preemption save.
    """

    def __init__(self, trainer, path: str, save_on_signal: bool = False,
                 exit_code: Optional[int] = 143):
        self.trainer = trainer
        self.path = path
        self.save_on_signal = save_on_signal
        self.exit_code = exit_code
        self.preempted = False
        self._prev = {}

    # -- signal plumbing ---------------------------------------------------
    def _handler(self, signum, frame):
        logger.warning("signal %d: preemption checkpoint requested", signum)
        self.preempted = True
        if self.save_on_signal:
            self._save_and_maybe_exit()

    def install(self) -> "PreemptionGuard":
        # Deferred mode needs a poll site: Trainer.fit polls stop_callback
        # between steps. A trainer without that hook (e.g. the standalone
        # RecVAETrainer) would swallow SIGTERM with no save and no exit —
        # refuse instead of degrading silently.
        if not self.save_on_signal \
                and not hasattr(self.trainer, "stop_callback"):
            raise ValueError(
                f"{type(self.trainer).__name__} has no stop_callback poll "
                "hook; use PreemptionGuard(..., save_on_signal=True) so the "
                "checkpoint is written directly from the signal handler.")
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev[sig] = signal.signal(sig, self._handler)
        if hasattr(self.trainer, "stop_callback"):
            self.trainer.stop_callback = self.should_stop
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}
        if getattr(self.trainer, "stop_callback", None) == self.should_stop:
            self.trainer.stop_callback = None

    def __enter__(self):
        return self.install()

    def __exit__(self, exc_type, exc, tb):
        self.uninstall()
        return False

    # -- checkpoint actions --------------------------------------------------
    def _save_and_maybe_exit(self) -> None:
        self.trainer.save(self.path)
        logger.warning("preemption checkpoint written to %s", self.path)
        if self.exit_code is not None:
            # flush logging handlers before the hard exit
            logging.shutdown()
            os._exit(self.exit_code)

    def should_stop(self) -> bool:
        """Poll from the training loop; saves + exits when preempted."""
        if self.preempted:
            self._save_and_maybe_exit()
            return True
        return False

    def has_checkpoint(self) -> bool:
        return os.path.exists(self.path)

    def restore(self) -> bool:
        """Load the preemption checkpoint into the trainer if one exists."""
        if not self.has_checkpoint():
            return False
        self.trainer.load(self.path)
        logger.info("resumed from preemption checkpoint %s (epoch %d, "
                    "step %d)", self.path, self.trainer.epoch,
                    self.trainer.step)
        return True
