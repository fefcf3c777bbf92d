"""Grid-search autotuner over the tuner_space cartesian expansion.

The port's own copy of `recbox_tpu/config/autotuner.py` (:1-111; it
imports no JAX, but the port imports nothing of the JAX package). The
reference (`recbox/ranking/autotuner.py:31-145`) expands a `tuner_space`
YAML into hashed-expid config files and greedily schedules one training
subprocess per GPU; here the expansion is `expand_tuner_space`
(`config.py`) and execution is either in-process or one subprocess per
card via `devices` — the same greedy queue. Two defaults differ from
JAX's: ``script`` is ``-m recbox_tpu_torch.run`` (the port's CLI) and the
card is chosen by ``CUDA_VISIBLE_DEVICES``; a subprocess runs under this
interpreter (`sys.executable`, JAX's runs ``python``).
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import yaml

from recbox_tpu_torch.config.config import expand_tuner_space

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["grid_search", "grid_search_subprocess", "save_tuner_configs"]


def save_tuner_configs(tuner_config: Dict[str, Any], out_dir: str) -> List[str]:
    """Materialize one model-config section per combination (reference
    `enumerate_params` writing config files with md5 expids)."""
    os.makedirs(out_dir, exist_ok=True)
    combos = expand_tuner_space(tuner_config)
    sections = {}
    for c in combos:
        eid = c["experiment_id"]
        # 8-hex md5 expids can collide (~1% by 300 combos); a dict
        # overwrite would silently drop a configuration from the sweep
        while eid in sections:
            eid = eid + "x"
        sections[eid] = {k: v for k, v in c.items()
                         if k != "experiment_id"}
    assert len(sections) == len(combos)
    path = os.path.join(out_dir, "model_config.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(sections, fh)
    return sorted(sections)


def grid_search(
    tuner_config: Dict[str, Any],
    run_fn: Callable[[Dict[str, Any]], Dict[str, float]],
    monitor: str = "AUC",
    mode: str = "max",
) -> List[Dict[str, Any]]:
    """Run every combination in-process; return results sorted best-first."""
    combos = expand_tuner_space(tuner_config)
    results = []
    for i, params in enumerate(combos):
        t0 = time.time()
        try:
            metrics = run_fn(params)
        except Exception as e:  # a failed combo shouldn't kill the sweep
            logger.exception("expid %s failed: %s", params["experiment_id"], e)
            continue
        results.append({"params": params, "metrics": metrics,
                        "seconds": round(time.time() - t0, 1)})
        logger.info("[%d/%d] %s -> %s", i + 1, len(combos),
                    params["experiment_id"], metrics)
    sign = -1 if mode == "max" else 1
    # runs missing the monitor metric must sort LAST in either mode
    # (sign * -inf would rank them FIRST under mode='min')
    results.sort(key=lambda r: sign * r["metrics"].get(
        monitor, float("-inf") if mode == "max" else float("inf")))
    return results


def grid_search_subprocess(
    expids: Sequence[str],
    script: str = "-m recbox_tpu_torch.run",
    config_dir: str = ".",
    devices: Sequence[str] = ("0",),
    env_var: str = "CUDA_VISIBLE_DEVICES",
    poll_seconds: float = 3.0,
) -> None:
    """Greedy device-queue scheduler: one `python script --config ... --expid
    ...` subprocess per free card (`autotuner.py:123-145` pattern).

    ``script`` is shlex-split, so both a path (``"train.py"``) and a module
    invocation (``"-m recbox_tpu_torch.run"``, the default) work. Non-zero
    exits are logged (the queue keeps draining, matching the reference
    scheduler).
    """
    import shlex
    script_argv = shlex.split(script)
    queue = list(expids)
    running: Dict[str, subprocess.Popen] = {}
    while queue or running:
        for dev in list(running):
            rc = running[dev].poll()
            if rc is not None:
                if rc != 0:
                    logger.warning("expid subprocess on %s=%s exited rc=%d",
                                   env_var, dev, rc)
                del running[dev]
        for dev in devices:
            if dev not in running and queue:
                expid = queue.pop(0)
                env = dict(os.environ, **{env_var: dev})
                running[dev] = subprocess.Popen(
                    [sys.executable, *script_argv, f"--config={config_dir}",
                     f"--expid={expid}"], env=env)
                logger.info("launched %s on %s=%s", expid, env_var, dev)
        time.sleep(poll_seconds)
