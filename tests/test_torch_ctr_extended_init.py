"""The port's initial draw of the extended CTR zoo against JAX's, on the
CPU.

Paired runs (the port started from JAX's weights) hold the forward pass and
training to JAX's; an unpaired run also needs the port to draw its weights
from JAX's distribution. For each model of `test_torch_ctr_extended.ZOO`
at dim 16, and for FiGNN and EulerNet at the quality exit's configuration
(`recbox_tpu_torch/tools/quality_exit.py` ``CTR_MODELS``: two fields of
201 and 301 ids, xavier-normal tables), JAX's ``init`` under keys 0..7 is
mapped to the port's names (`interop.from_jax_params`) and set beside
eight fresh port models drawn from ``torch.Generator`` seeds 0..7. Per
parameter, pooled over the eight draws:

- a constant draw (zeros, ones) is the same constant in both;
- otherwise the two samples pass a two-sample Kolmogorov-Smirnov test at
  p >= 1e-4 (a shape, scale or mean apart), their standard deviations
  agree within 4 / sqrt(2 n) + 0.02 relative (n values a side), and at
  most 12 values of either sample lie beyond the other's largest |value|
  (a sample's top 12 all from one side has chance ~2^-12 where both draw
  alike; a plain normal beside flax's normal truncated at two standard
  deviations puts ~2% of its values there).
"""

import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

import test_torch_ctr_extended as X
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.interop import from_jax_params
from recbox_tpu_torch.models import ranking as P

DIM, SEEDS, TAIL = 16, range(8), 12
# the quality exit's FiGNN / EulerNet (`tools/parity_run_ours_ctrx.py`)
EXIT = [("FiGNN", dict(gnn_steps=2, att_dim=16, num_heads=2)),
        ("EulerNet", dict(order_layers=(16,), apply_norm=False))]


def _check_draws(jm, make_port, batch):
    init = jax.jit(jm.init)
    jax_draws, port_draws = {}, {}
    for s in SEEDS:
        pm = make_port(torch.Generator().manual_seed(s))
        params = X._np_tree(init(jax.random.PRNGKey(s), batch))["params"]
        for k, v in from_jax_params(params, pm).items():
            jax_draws.setdefault(k, []).append(v.numpy().ravel())
        for k, v in pm.state_dict().items():
            port_draws.setdefault(k, []).append(v.numpy().ravel())
    assert set(jax_draws) == set(port_draws)
    for k in jax_draws:
        j, p = np.concatenate(jax_draws[k]), np.concatenate(port_draws[k])
        if j.std() == 0 or p.std() == 0:
            assert j.std() == p.std() == 0 and j[0] == p[0], k
            continue
        assert ks_2samp(j, p).pvalue >= 1e-4, (k, ks_2samp(j, p))
        assert abs(p.std() / j.std() - 1) <= 4 / np.sqrt(2 * j.size) + 0.02, \
            (k, j.std(), p.std())
        beyond = (int((np.abs(p) > np.abs(j).max()).sum()),
                  int((np.abs(j) > np.abs(p).max()).sum()))
        assert max(beyond) <= TAIL, (k, beyond)


@pytest.mark.parametrize("name,kw", X.ZOO, ids=X.IDS)
def test_extended_zoo_initial_draw_matches_jax(name, kw):
    jfm = JFeatureMap("t", X._specs(JFeatureSpec), labels=("click",))
    pfm = FeatureMap("t", X._specs(FeatureSpec), labels=("click",))
    kw = dict(kw, embedding_dim=DIM)
    _check_draws(X._jclass(name)(feature_map=jfm, **kw),
                 lambda g: getattr(P, name)(pfm, device="cpu", generator=g,
                                            **kw),
                 X._batch(0))


@pytest.mark.parametrize("name,kw", EXIT, ids=[n for n, _ in EXIT])
def test_quality_exit_initial_draw_matches_jax(name, kw):
    def specs(S):
        return (S("user_id", "categorical", vocab_size=201,
                  embedding_dim=DIM),
                S("item_id", "categorical", vocab_size=301,
                  embedding_dim=DIM))

    kw = dict(kw, embedding_dim=DIM, emb_init_scheme="xavier_normal")
    jfm = JFeatureMap("sctr", specs(JFeatureSpec), labels=("label",))
    pfm = FeatureMap("sctr", specs(FeatureSpec), labels=("label",))
    rng = np.random.default_rng(0)
    batch = {"user_id": rng.integers(0, 201, 16).astype(np.int32),
             "item_id": rng.integers(0, 301, 16).astype(np.int32)}
    _check_draws(getattr(X.JX, name)(feature_map=jfm, **kw),
                 lambda g: getattr(P, name)(pfm, device="cpu", generator=g,
                                            **kw),
                 batch)
