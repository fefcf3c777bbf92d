"""One-command experiment runner: config dir + expid → train → metrics.

    python -m recbox_tpu_torch.run --config=<dir> --expid=<id> [--key=value ...]

Counterpart of `recbox_tpu/run.py` (:1-157): `run_expid`, `_finish` and
`main`. The command prints the result as one JSON line (and appends it to
``<workdir>/results.jsonl`` when the config names a ``workdir``); a call
without ``--config`` or ``--expid`` prints the usage and exits 2.
`config.autotuner.grid_search_subprocess` launches this module.

Config contract (`config/config.py` has the YAML layout):
  model section   — ``model`` (a registered name), its hyperparameters,
                    the trainer's knobs (``learning_rate``, ``epochs``,
                    ``batch_size``, ...), ``dataset_id``.
  dataset section — ``data_dir``: a directory holding ``feature_map.json``
                    (`FeatureMap.save`) and ``train.npz`` / ``valid.npz``
                    (optionally ``test.npz``) of encoded columns.

Three routes, as in JAX: ``model: cascade`` with a ``dataset`` name runs
`quick_start.run_cascade_experiment`; a ``dataset`` name without a
``data_dir`` runs `quick_start.run_experiment` (acquire, load, split,
train, evaluate); a ``data_dir`` runs the ranking or sequential pipeline
over its arrays (another stage raises NotImplementedError). The device is
the config's ``device`` key (``--device=cpu`` on the command line sets
it), the CUDA card by default (`recbox_tpu_torch.resolve_device`).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, Mapping, Optional

import numpy as np

__all__ = ["run_expid", "main"]


def _load_split(data_dir: str, split: str) -> Optional[Dict[str, np.ndarray]]:
    path = os.path.join(data_dir, f"{split}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def run_expid(config_dir: str, experiment_id: str,
              overrides: Optional[Mapping[str, Any]] = None,
              cli: bool = False) -> Dict[str, float]:
    """Train one configured experiment and return its final metrics."""
    from recbox_tpu_torch import quick_start
    from recbox_tpu_torch.config import load_config
    from recbox_tpu_torch.features import FeatureMap
    from recbox_tpu_torch.models.registry import get_model

    cfg = load_config(config_dir, experiment_id, cli=cli,
                      overrides=dict(overrides) if overrides else None)
    device = cfg.get("device")
    data_dir = cfg.get("data_dir")
    if cfg.get("model") == "cascade":
        if not cfg.get("dataset"):
            raise KeyError(
                f"expid {experiment_id!r}: model 'cascade' needs a "
                "`dataset` name (the cascade derives all three stages' "
                "supervision from one interaction file)")
        metrics = quick_start.run_cascade_experiment(
            cfg["dataset"], matcher=cfg.get("matcher", "MF"),
            ranker=cfg.get("ranker", "DCN"),
            reranker=cfg.get("reranker", "PRM"), config=dict(cfg),
            device=device)
        return _finish(cfg, experiment_id, metrics,
                       dataset_id=cfg["dataset"])
    if not data_dir and cfg.get("dataset"):
        metrics = quick_start.run_experiment(
            cfg["model"], cfg["dataset"], config=dict(cfg), device=device)
        return _finish(cfg, experiment_id, metrics,
                       dataset_id=cfg["dataset"])
    if not data_dir:
        raise KeyError(
            f"expid {experiment_id!r}: no `data_dir` (pre-encoded npz dir) "
            "and no `dataset` (raw dataset name for the one-call "
            "acquire→load→split→train chain) — set one of them.")
    fm = FeatureMap.load(os.path.join(data_dir, "feature_map.json"))
    train = _load_split(data_dir, "train")
    valid = _load_split(data_dir, "valid")
    if train is None or valid is None:
        raise FileNotFoundError(
            f"{data_dir} must contain train.npz and valid.npz")
    test = _load_split(data_dir, "test")

    _, stage = get_model(cfg["model"])
    if stage in ("ranking", "multitask"):
        metrics = quick_start.run_ranking_experiment(
            cfg, fm, train, valid, test_arrays=test, device=device)
    elif stage == "sequential":
        ks = cfg.get("topk", (10, 20))
        ks = (int(ks),) if isinstance(ks, int) else tuple(ks)
        metrics = quick_start.run_sequential_experiment(
            cfg, fm, train, valid, test_arrays=test, ks=ks, device=device)
    else:
        raise NotImplementedError(
            f"model {cfg['model']!r} is stage {stage!r}; the CLI covers "
            "ranking/multitask/sequential — use the quick_start."
            f"run_{stage}_experiment API for this stage (it needs "
            "stage-specific eval structures a flat npz dir cannot express).")

    return _finish(cfg, experiment_id, metrics,
                   dataset_id=cfg.get("dataset_id"))


def _finish(cfg, experiment_id, metrics, dataset_id=None):
    """One result schema and one append path for every route."""
    result = {"experiment_id": experiment_id, "model": cfg["model"],
              "dataset_id": dataset_id, **metrics}
    workdir = cfg.get("workdir")
    if workdir:
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "results.jsonl"), "a") as fh:
            fh.write(json.dumps(result) + "\n")
    return result


def main(argv=None) -> Dict[str, float]:
    args = list(sys.argv[1:] if argv is None else argv)
    config_dir = expid = None
    rest = []
    for a in args:
        if a.startswith("--config="):
            config_dir = a.split("=", 1)[1]
        elif a.startswith("--expid="):
            expid = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not config_dir or not expid:
        print("usage: python -m recbox_tpu_torch.run --config=<dir> "
              "--expid=<id> [--key=value ...]", file=sys.stderr)
        raise SystemExit(2)
    # the remaining --key=value pairs, typed by the config system's
    # literal-eval rules, from THIS argv only
    from recbox_tpu_torch.config import parse_cli_overrides
    result = run_expid(config_dir, expid,
                       overrides=parse_cli_overrides(rest))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
