"""Hyper-parameter tuning beyond grid search.

The port's own copy of `recbox_tpu/config/hyper_tuning.py` (:1-196; numpy
only), draw for draw: the same seed gives the same trials. Re-design of recbole's HyperTuning (`third_party/recbole/trainer/
hyper_tuning.py:157-420`, which wraps hyperopt) without the hyperopt
dependency: the same three algorithms — exhaustive, random, and a
TPE-flavored 'bayes' — over the same space grammar, with the same
no-progress early stop.

Space grammar (per parameter):
    ("choice", [v1, v2, ...])
    ("uniform", lo, hi)
    ("loguniform", lo, hi)          # hi/lo in natural units
    ("quniform", lo, hi, q)         # rounded to multiples of q

The 'bayes' algorithm is a compact TPE: after `n_startup` random trials,
candidates are sampled from a kernel density fit to the best γ-quantile of
past trials and ranked by the good/bad density ratio — the core of
hyperopt's tree-structured Parzen estimator, minus its adaptive bandwidth
schedule.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["HyperTuning"]


def _sample_param(spec, rng: np.random.Generator):
    kind = spec[0]
    if kind == "choice":
        return spec[1][int(rng.integers(len(spec[1])))]
    if kind == "uniform":
        return float(rng.uniform(spec[1], spec[2]))
    if kind == "loguniform":
        return float(np.exp(rng.uniform(np.log(spec[1]), np.log(spec[2]))))
    if kind == "quniform":
        v = rng.uniform(spec[1], spec[2])
        return float(np.round(v / spec[3]) * spec[3])
    raise ValueError(f"unknown space kind {kind!r}")


def _to_unit(spec, v) -> float:
    """Map a value into [0, 1] for KDE distance computations."""
    kind = spec[0]
    if kind == "choice":
        return spec[1].index(v) / max(len(spec[1]) - 1, 1)
    if kind == "loguniform":
        return ((math.log(v) - math.log(spec[1]))
                / max(math.log(spec[2]) - math.log(spec[1]), 1e-12))
    lo, hi = spec[1], spec[2]
    return (v - lo) / max(hi - lo, 1e-12)


class HyperTuning:
    """Runs `objective(params) -> {'metric': float, ...}` over a space.

    Args:
      objective: callable returning a dict containing `metric_key`.
      space: {name: spec} per the module grammar.
      algo: 'exhaustive' | 'random' | 'bayes'.
      max_evals: trial budget (exhaustive ignores it when smaller).
      metric_key / mode: what to optimize and direction.
      early_stop: stop after this many trials without improvement
        (hyperopt's no_progress_loss analog).
    """

    def __init__(self, objective: Callable[[Dict[str, Any]], Dict[str, float]],
                 space: Dict[str, Tuple], algo: str = "random",
                 max_evals: int = 20, metric_key: str = "metric",
                 mode: str = "max", early_stop: int = 10, seed: int = 0,
                 n_startup: int = 5, gamma: float = 0.3,
                 n_candidates: int = 24):
        assert algo in ("exhaustive", "random", "bayes")
        assert mode in ("max", "min")
        self.objective = objective
        self.space = space
        self.algo = algo
        self.max_evals = max_evals
        self.metric_key = metric_key
        self.mode = mode
        self.early_stop = early_stop
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.trials: List[Dict[str, Any]] = []
        self.best_params: Optional[Dict[str, Any]] = None
        self.best_score: Optional[float] = None

    # -- candidate generation -------------------------------------------
    def _exhaustive_params(self):
        for spec in self.space.values():
            if spec[0] != "choice":
                raise ValueError("exhaustive search needs 'choice' specs "
                                 "(recbole raises the same)")
        keys = list(self.space)
        for combo in itertools.product(*(self.space[k][1] for k in keys)):
            yield dict(zip(keys, combo))

    def _random_params(self) -> Dict[str, Any]:
        return {k: _sample_param(s, self.rng) for k, s in self.space.items()}

    def _bayes_params(self) -> Dict[str, Any]:
        if len(self.trials) < self.n_startup:
            return self._random_params()
        scores = np.array([t["score"] for t in self.trials])
        if self.mode == "max":
            scores = -scores
        n_good = max(1, int(np.ceil(self.gamma * len(scores))))
        good_idx = np.argsort(scores)[:n_good]
        good = [self.trials[i]["params"] for i in good_idx]
        bad = [t["params"] for i, t in enumerate(self.trials)
               if i not in set(good_idx.tolist())] or good
        bw = 0.15

        def density(params, pool):
            d = 0.0
            for k, spec in self.space.items():
                u = _to_unit(spec, params[k])
                us = np.array([_to_unit(spec, p[k]) for p in pool])
                d += np.log(np.mean(
                    np.exp(-0.5 * ((u - us) / bw) ** 2)) + 1e-12)
            return d

        best_c, best_ratio = None, -np.inf
        for _ in range(self.n_candidates):
            # perturb a random good trial (Parzen sampling)
            base = good[int(self.rng.integers(len(good)))]
            cand = {}
            for k, spec in self.space.items():
                if spec[0] == "choice":
                    if self.rng.random() < 0.7:
                        cand[k] = base[k]
                    else:
                        cand[k] = _sample_param(spec, self.rng)
                else:
                    u = _to_unit(spec, base[k]) + self.rng.normal(0, bw)
                    u = float(np.clip(u, 0.0, 1.0))
                    if spec[0] == "loguniform":
                        cand[k] = float(np.exp(
                            math.log(spec[1]) + u * (math.log(spec[2])
                                                     - math.log(spec[1]))))
                    else:
                        v = spec[1] + u * (spec[2] - spec[1])
                        if spec[0] == "quniform":
                            v = float(np.round(v / spec[3]) * spec[3])
                        cand[k] = float(v)
            ratio = density(cand, good) - density(cand, bad)
            if ratio > best_ratio:
                best_c, best_ratio = cand, ratio
        return best_c

    # -- the trial loop ----------------------------------------------------
    def _better(self, score: float) -> bool:
        if self.best_score is None:
            return True
        return (score > self.best_score if self.mode == "max"
                else score < self.best_score)

    def run(self) -> Dict[str, Any]:
        gen = (self._exhaustive_params() if self.algo == "exhaustive"
               else iter(lambda: (self._bayes_params()
                                  if self.algo == "bayes"
                                  else self._random_params()), None))
        since_best = 0
        for i, params in enumerate(gen):
            if i >= self.max_evals:
                break
            result = self.objective(dict(params))
            score = float(result[self.metric_key])
            self.trials.append({"params": dict(params), "score": score,
                                "result": result})
            if self._better(score):
                self.best_score = score
                self.best_params = dict(params)
                since_best = 0
            else:
                since_best += 1
            if since_best >= self.early_stop:
                break
        return {"best_params": self.best_params,
                "best_score": self.best_score,
                "n_trials": len(self.trials)}

    def export_result(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            for t in self.trials:
                fh.write(json.dumps(t) + "\n")
