"""Unified YAML config system with Base inheritance, CLI override, expids.

One config system replacing the reference's four (SURVEY §5.6):
  1. recbox experiment configs — `dataset_config.yaml` + `model_config.yaml`
     with a `Base` section every expid inherits (`recbox/ranking/utils.py:
     27-67`);
  2. recbole's priority merge CLI > dict > file with typed `eval` re-parse
     (`config/configurator.py:37-200`);
  3. tuner cartesian expansion with md5 expids (`autotuner.py:31-110`);
  4. daisy's basic+algo yaml + argparse.

The port's own copy of `recbox_tpu/config/config.py` (it imports no JAX,
but the port imports nothing of the JAX package), unchanged in function;
`autotuner.py` and `hyper_tuning.py` beside it are copies too.

`load_config(config_dir, experiment_id)` reads both files, resolves
`Base` inheritance and the experiment's `dataset_id`; `Config.merge`
applies dict and `--key=value` CLI overrides with literal-eval typing.
"""

from __future__ import annotations

import ast
import glob
import hashlib
import itertools
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Config", "load_config", "parse_cli_overrides", "hash_expid",
           "expand_tuner_space"]


def _literal(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def parse_cli_overrides(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """`--key=value` pairs from argv, typed via literal_eval (recbole
    `configurator.py:165-193` semantics)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    out: Dict[str, Any] = {}
    for arg in argv:
        if arg.startswith("--") and "=" in arg:
            k, v = arg[2:].split("=", 1)
            out[k] = _literal(v)
    return out


def hash_expid(params: Dict[str, Any], base: str = "") -> str:
    """Deterministic md5 expid for a parameter combination
    (`autotuner.py:95-108` pattern)."""
    blob = repr(sorted(params.items()))
    return f"{base}_{hashlib.md5(blob.encode()).hexdigest()[:8]}" if base \
        else hashlib.md5(blob.encode()).hexdigest()[:8]


class Config(dict):
    """Dict with attribute access and priority-aware merging."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def merge(self, *overrides: Optional[Dict[str, Any]]) -> "Config":
        """Later sources win (file < dict < CLI — recbole priority)."""
        out = Config(self)
        for ov in overrides:
            if ov:
                out.update(ov)
        return out


def _load_yaml_sections(paths: List[str]) -> Dict[str, dict]:
    # imported here: `Config` alone needs no yaml, and the card's machine
    # may not carry it
    import yaml

    merged: Dict[str, dict] = {}
    for path in paths:
        with open(path) as fh:
            doc = yaml.safe_load(fh) or {}
        for key, section in doc.items():
            merged.setdefault(key, {}).update(section or {})
    return merged


def load_config(config_dir: str, experiment_id: str,
                cli: bool = False,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load an experiment config from a config dir.

    Layout (reference `recbox/ranking/utils.py:27-67`):
      <dir>/model_config.yaml (or model_config/*.yaml): `Base` + one section
        per experiment_id;
      <dir>/dataset_config.yaml (or dataset_config/*.yaml): one section per
        dataset_id, referenced by the experiment's `dataset_id` key.
    """
    model_paths = sorted(
        glob.glob(os.path.join(config_dir, "model_config.yaml"))
        + glob.glob(os.path.join(config_dir, "model_config", "*.yaml")))
    dataset_paths = sorted(
        glob.glob(os.path.join(config_dir, "dataset_config.yaml"))
        + glob.glob(os.path.join(config_dir, "dataset_config", "*.yaml")))
    if not model_paths:
        raise FileNotFoundError(f"no model_config yaml under {config_dir}")
    model_sections = _load_yaml_sections(model_paths)
    if experiment_id not in model_sections:
        raise KeyError(f"expid {experiment_id!r} not found in {model_paths}")
    cfg = Config(model_sections.get("Base", {}))
    cfg.update(model_sections[experiment_id])
    cfg["experiment_id"] = experiment_id

    dataset_id = cfg.get("dataset_id")
    if dataset_id and dataset_paths:
        dataset_sections = _load_yaml_sections(dataset_paths)
        if dataset_id not in dataset_sections:
            raise KeyError(f"dataset_id {dataset_id!r} not found in {dataset_paths}")
        # dataset section OVERRIDES Base/expid keys — reference precedence
        # (`ranking/utils.py:27-31` params.update(data_params)); CLI and
        # dict overrides below still win over everything
        cfg.update(dataset_sections[dataset_id])
    return cfg.merge(overrides, parse_cli_overrides() if cli else None)


def expand_tuner_space(tuner_config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cartesian-product expansion of a `tuner_space` dict: every list-valued
    key becomes an axis (`autotuner.py:31-94`). Returns one param dict per
    combination, each with a hashed `experiment_id`."""
    space = dict(tuner_config.get("tuner_space", tuner_config))
    base = tuner_config.get("base_expid", "tuner")
    axes = {k: (v if isinstance(v, list) else [v]) for k, v in space.items()}
    keys = sorted(axes)
    combos = []
    for values in itertools.product(*(axes[k] for k in keys)):
        params = dict(zip(keys, values))
        params["experiment_id"] = hash_expid(params, base)
        combos.append(params)
    return combos
