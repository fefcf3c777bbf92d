"""The port's XGBoost / LightGBM passthroughs against the JAX package's, on
the CPU, over fake boosters.

Neither package is a dependency of either side, so both wrappers run over
the deterministic fakes of `tests/test_exlib_stub.py` in `sys.modules`:
the same parameters, rounds, evaluation sets, early-stopping wiring and
predictions (bit for bit: the fakes are numpy). Without the package the
port's constructor raises ImportError naming the port's LambdaMART.
"""

import builtins
import sys

import numpy as np
import pytest

from recbox_tpu.models import exlib as J
from recbox_tpu_torch.models import exlib as P
from test_exlib_stub import _fake_lightgbm, _fake_xgboost, _linear_ctr


@pytest.fixture
def fake_boosters(monkeypatch):
    monkeypatch.setitem(sys.modules, "xgboost", _fake_xgboost())
    monkeypatch.setitem(sys.modules, "lightgbm", _fake_lightgbm())


@pytest.mark.parametrize("name,kw,booster_keys", [
    ("XGBoostRecommender", dict(max_depth=3),
     ("num_rounds", "eval_names", "early_stopping_rounds")),
    ("LightGBMRecommender", dict(num_leaves=15),
     ("num_rounds", "n_valid_sets", "callbacks")),
])
def test_passthrough_wiring_matches_jax(fake_boosters, name, kw,
                                        booster_keys):
    X, y = _linear_ctr(300, 0)
    Xv, yv = _linear_ctr(80, 1)
    jm, pm = getattr(J, name)(**kw), getattr(P, name)(**kw)
    assert pm.params == jm.params
    for fit_kw in (dict(num_rounds=7, valid=(Xv, yv)),
                   dict(num_rounds=5, valid=(Xv, yv),
                        early_stopping_rounds=2),
                   dict(num_rounds=3)):
        assert jm.fit(X, y, **fit_kw) is jm and pm.fit(X, y, **fit_kw) is pm
        for key in booster_keys:
            assert getattr(pm.booster, key, None) == \
                getattr(jm.booster, key, None), key
        np.testing.assert_array_equal(pm.predict(Xv), jm.predict(Xv))
    with pytest.raises(ValueError, match="valid"):
        pm.fit(X, y, early_stopping_rounds=3)


@pytest.mark.parametrize("name,pkg", [("XGBoostRecommender", "xgboost"),
                                      ("LightGBMRecommender", "lightgbm")])
def test_missing_package_names_the_ports_lambdamart(monkeypatch, name, pkg):
    real_import = builtins.__import__

    def refuse(mod, *a, **k):
        if mod == pkg:
            raise ImportError("absent")
        return real_import(mod, *a, **k)

    monkeypatch.setitem(sys.modules, pkg, None)
    monkeypatch.setattr(builtins, "__import__", refuse)
    with pytest.raises(ImportError, match="recbox_tpu_torch.models."
                       "reranking.lambdamart.LambdaMART"):
        getattr(P, name)()
