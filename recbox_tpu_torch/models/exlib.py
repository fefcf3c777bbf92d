"""External-library passthrough models: XGBoost and LightGBM.

Counterpart of `recbox_tpu/models/exlib.py` (`XGBoostRecommender` :24,
`LightGBMRecommender` :63): thin fit / predict wrappers over the external
boosters, host code as in the JAX package. Neither package is a dependency
of the port: construction imports it and, where it is missing, raises
ImportError naming the native GBDT,
`recbox_tpu_torch.models.reranking.lambdamart.LambdaMART`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["XGBoostRecommender", "LightGBMRecommender"]

_FALLBACK_MSG = ("{pkg} is not installed in this environment; use the "
                 "native GBDT (recbox_tpu_torch.models.reranking.lambdamart."
                 "LambdaMART).")


class XGBoostRecommender:
    """xgboost passthrough (binary CTR objective by default)."""

    def __init__(self, **params):
        try:
            import xgboost  # noqa: F401
        except ImportError as e:
            raise ImportError(_FALLBACK_MSG.format(pkg="xgboost")) from e
        self._xgb = __import__("xgboost")
        self.params = {"objective": "binary:logistic",
                       "eval_metric": "auc", **params}
        self.booster = None

    def fit(self, X: np.ndarray, y: np.ndarray, num_rounds: int = 100,
            valid: Optional[tuple] = None,
            early_stopping_rounds: Optional[int] = None):
        """`early_stopping_rounds` mirrors the reference DecisionTree
        trainer's `xgb_early_stopping_rounds`
        (`third_party/recbole/trainer/trainer.py:1082,1117`); it needs a
        `valid` set to monitor."""
        if early_stopping_rounds is not None and valid is None:
            raise ValueError("early_stopping_rounds needs a valid set")
        dtrain = self._xgb.DMatrix(X, label=y)
        evals = [(dtrain, "train")]
        if valid is not None:
            evals.append((self._xgb.DMatrix(valid[0], label=valid[1]),
                          "valid"))
        kw = {}
        if early_stopping_rounds is not None:
            kw["early_stopping_rounds"] = early_stopping_rounds
        self.booster = self._xgb.train(self.params, dtrain, num_rounds,
                                       evals=evals, verbose_eval=False,
                                       **kw)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.booster.predict(self._xgb.DMatrix(X))


class LightGBMRecommender:
    """lightgbm passthrough (binary CTR objective by default)."""

    def __init__(self, **params):
        try:
            import lightgbm  # noqa: F401
        except ImportError as e:
            raise ImportError(_FALLBACK_MSG.format(pkg="lightgbm")) from e
        self._lgb = __import__("lightgbm")
        self.params = {"objective": "binary", "metric": "auc", **params}
        self.booster = None

    def fit(self, X: np.ndarray, y: np.ndarray, num_rounds: int = 100,
            valid: Optional[tuple] = None,
            early_stopping_rounds: Optional[int] = None):
        """`early_stopping_rounds` mirrors the reference's
        `lgb_early_stopping_rounds`
        (`third_party/recbole/trainer/trainer.py:1160,1194`); modern
        lightgbm takes it as an early_stopping callback."""
        if early_stopping_rounds is not None and valid is None:
            raise ValueError("early_stopping_rounds needs a valid set")
        dtrain = self._lgb.Dataset(X, label=y)
        valid_sets = [dtrain]
        if valid is not None:
            valid_sets.append(self._lgb.Dataset(valid[0], label=valid[1]))
        kw = {}
        if early_stopping_rounds is not None:
            kw["callbacks"] = [
                self._lgb.early_stopping(early_stopping_rounds)]
        self.booster = self._lgb.train(self.params, dtrain, num_rounds,
                                       valid_sets=valid_sets, **kw)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.booster.predict(X)
