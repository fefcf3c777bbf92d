"""The port's `utils/` (`recbox_tpu_torch/utils/`) against the JAX
package's, on the CPU.

Mirrors `tests/test_preemption.py` (SIGTERM mid-fit saves, a new process
resumes; in subprocesses, over the port's Trainer and LR) and the utils
cases of `tests/test_aux_subsystems.py`. Where a function is host Python in
both packages (`seed_everything`'s Python and numpy streams,
`MetricsWriter`'s records, `set_logger`'s handlers, `WandbLogger`) the
port's output is held to JAX's. `estimate_cost`, `get_environment` and
`get_device_memory` read torch where JAX reads XLA (their keys:
`ROADMAP.md` Queue C).
"""

import json
import logging
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from recbox_tpu.utils import logging as jlogging
from recbox_tpu.utils import seeding as jseeding
from recbox_tpu_torch import utils
from recbox_tpu_torch.utils.introspection import (
    count_params, estimate_cost, get_device_memory, get_environment,
)
from recbox_tpu_torch.utils.logging import (
    MetricsWriter, WandbLogger, profile_step, set_logger,
)
from recbox_tpu_torch.utils.preemption import PreemptionGuard
from recbox_tpu_torch.utils.seeding import seed_everything

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    from recbox_tpu_torch.data import ArrayLoader
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.ranking import LR
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    from recbox_tpu_torch.utils.preemption import PreemptionGuard

    fm = FeatureMap("pg", (FeatureSpec("a", "categorical", vocab_size=32,
                                       embedding_dim=4),), labels=("y",))
    rng = np.random.default_rng(0)
    arrays = {{"a": rng.integers(1, 32, 4000).astype(np.int32),
              "y": (rng.random(4000) > 0.5).astype(np.float32)}}
    t = Trainer(LR(fm, generator=torch.Generator().manual_seed(0),
                   device="cpu"),
                lambda o, b: binary_crossentropy(o, b["y"]),
                TrainerConfig(learning_rate=1e-2, epochs=50, monitor="AUC"),
                device="cpu")
    guard = PreemptionGuard(t, {ckpt!r}).install()

    class SelfPreempt:
        def __init__(self, inner):
            self.inner = inner
            self.steps = 0
        def __iter__(self):
            for b in self.inner:
                self.steps += 1
                if self.steps == 5:      # preempt mid-epoch
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b
        def peek_batch(self):
            return self.inner.peek_batch()

    t.fit(SelfPreempt(ArrayLoader(arrays, batch_size=64, drop_last=True)))
    print("SHOULD NOT REACH HERE")
""")

_RESUME = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.ranking import LR
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    from recbox_tpu_torch.utils.preemption import PreemptionGuard

    fm = FeatureMap("pg", (FeatureSpec("a", "categorical", vocab_size=32,
                                       embedding_dim=4),), labels=("y",))
    t = Trainer(LR(fm, generator=torch.Generator().manual_seed(1),
                   device="cpu"),
                lambda o, b: binary_crossentropy(o, b["y"]),
                TrainerConfig(learning_rate=1e-2, monitor="AUC"),
                device="cpu")
    t.init({{"a": np.array([1, 2], np.int32),
            "y": np.array([1., 0.], np.float32)}})
    guard = PreemptionGuard(t, {ckpt!r})
    assert guard.has_checkpoint()
    assert guard.restore()
    # the step counter is the preempted step's (the interrupted epoch
    # replays from its first batch: the loader position is not state)
    assert t.step == 4, t.step
    print("RESUMED_OK", t.step)
""")


def test_sigterm_saves_and_resumes(tmp_path):
    ckpt = str(tmp_path / "preempt.ckpt")
    env = {**os.environ, "PYTHONPATH": ""}
    p = subprocess.run(
        [sys.executable, "-c", _WORKER.format(repo=REPO, ckpt=ckpt)],
        capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 143, (p.returncode, p.stdout, p.stderr)
    assert "SHOULD NOT REACH HERE" not in p.stdout
    assert os.path.exists(ckpt)
    p2 = subprocess.run(
        [sys.executable, "-c", _RESUME.format(repo=REPO, ckpt=ckpt)],
        capture_output=True, text=True, env=env, timeout=300)
    assert p2.returncode == 0, (p2.stdout, p2.stderr)
    assert "RESUMED_OK 4" in p2.stdout


class _NoPoll:
    def save(self, path):
        with open(path, "w") as fh:
            fh.write("saved")


def test_install_refuses_a_trainer_without_stop_callback(tmp_path):
    with pytest.raises(ValueError, match="stop_callback"):
        PreemptionGuard(_NoPoll(), str(tmp_path / "c")).install()
    guard = PreemptionGuard(_NoPoll(), str(tmp_path / "c"),
                            save_on_signal=True, exit_code=None)
    with guard:
        guard._handler(15, None)
    assert guard.preempted and guard.has_checkpoint()


def test_guard_sets_and_clears_the_poll(tmp_path):
    class Polled(_NoPoll):
        stop_callback = None
        step = epoch = 0

    t = Polled()
    guard = PreemptionGuard(t, str(tmp_path / "c"), exit_code=None)
    with guard:
        assert t.stop_callback == guard.should_stop
        assert not guard.should_stop()
        guard._handler(15, None)
        assert guard.should_stop() and guard.has_checkpoint()
    assert t.stop_callback is None


def test_cost_and_params():
    x, w = torch.ones(8, 16), torch.ones(16, 4)
    cost = estimate_cost(lambda x, w: x @ w, x, w)
    assert cost["flops"] >= 2 * 8 * 16 * 4 * 0.5  # >= one MAC per output
    assert cost == {"flops": 2.0 * 8 * 16 * 4, "bytes_accessed": 0.0,
                    "optimal_seconds": 0.0}
    assert count_params({"a": x, "b": {"c": w}}) == 8 * 16 + 16 * 4
    lin = torch.nn.Linear(16, 4)
    assert count_params(lin) == 16 * 4 + 4 == count_params(lin.state_dict())
    assert count_params({"a": np.zeros((3, 5)), "b": [np.zeros(2)]}) == 17


def test_environment():
    env = get_environment()
    assert env["backend"] in ("cpu", "cuda")
    assert int(env["num_devices"]) >= 1
    assert env["torch"] == torch.__version__
    assert set(env) == {"python", "torch", "backend", "num_devices",
                        "device_kind", "host_count"}


def test_wandb_logger_noop():
    wl = WandbLogger(enabled=False)
    wl.log_metrics({"a": 1.0}, step=0)   # must not raise
    wl.finish()
    wl2 = WandbLogger(enabled=True)      # wandb not installed → disabled
    wl2.log_metrics({"a": 1.0})
    wl2.finish()
    assert wl._run is None and wl2._run is jlogging.WandbLogger(True)._run


def test_device_memory_stats():
    out = get_device_memory()
    assert isinstance(out, dict)         # the CPU reports nothing
    if not torch.cuda.is_available():
        assert out == {} and get_device_memory("cpu") == {}
    for v in out.values():
        assert v >= 0


def test_seed_everything_equals_jax_streams():
    draws = []
    for seed_fn in (jseeding.seed_everything, seed_everything):
        seed_fn(123)
        draws.append((random.random(), np.random.rand(3).tolist(),
                      os.environ["PYTHONHASHSEED"]))
    assert draws[0] == draws[1]
    seed_everything(7)
    a = torch.rand(4)
    seed_everything(7)
    assert torch.equal(a, torch.rand(4))


def test_metrics_writer_records_equal_jax(tmp_path):
    recs = []
    for mod, d in ((jlogging, "j"), (utils.logging, "p")):
        w = mod.MetricsWriter(str(tmp_path / d))
        w.log({"loss": 0.5, "auc": float("nan"), "n": np.float32(2)}, step=3)
        w.log({"loss": float("inf")}, step=4)
        w.close()
        with open(tmp_path / d / "metrics.jsonl") as fh:
            recs.append([{k: v for k, v in json.loads(line).items()
                          if k != "time"} for line in fh])
    assert recs[0] == recs[1]
    assert recs[1][0] == {"step": 3, "loss": 0.5, "auc": None, "n": 2.0}


def test_set_logger_handlers(tmp_path):
    log = tmp_path / "sub" / "run.log"
    for _ in range(2):                    # reconfiguring leaks no handler
        logger = set_logger(str(log))
    assert logger.name == "recbox_tpu_torch" and len(logger.handlers) == 2
    logger.info("hello")
    for h in logger.handlers:
        h.flush()
    assert "hello" in log.read_text()
    jl = jlogging.set_logger(str(tmp_path / "j.log"))
    assert [type(h) for h in jl.handlers] == [type(h) for h in logger.handlers]
    for lg in (logger, jl):
        for h in lg.handlers:
            h.close()
        lg.handlers.clear()


def test_profile_step_writes_a_trace(tmp_path):
    with profile_step(None):
        pass
    assert not list(tmp_path.iterdir())
    with profile_step(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_exports_equal_jax():
    from recbox_tpu import utils as jutils
    assert utils.__all__ == jutils.__all__
    assert utils.seed_everything is seed_everything
    assert utils.set_logger is set_logger and utils.MetricsWriter \
        is MetricsWriter and utils.profile_step is profile_step
    assert logging.getLogger("recbox_tpu_torch") is not None
