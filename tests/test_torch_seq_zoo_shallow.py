"""The port's shallow and user-conditioned sequential models against JAX's,
on the CPU: FPMC, TransRec, HGN, SHAN, FOSSIL, HRM, NPE, RepeatNet and
SINE. The checks, sizes, batch and tolerances are
`test_torch_sequential_zoo.py`'s (its docstring states them).
"""

import numpy as np
import pytest
import torch

from test_torch_sequential_zoo import (
    _batch, _jax, _pmodel, _tb, check_adam_step, check_ce_gradients,
    check_forward,
)

HERE = ("FPMC", "TransRec", "HGN", "SHAN", "FOSSIL", "HRM", "NPE",
        "RepeatNet", "SINE")


@pytest.mark.parametrize("name", HERE)
def test_forward_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", HERE)
def test_ce_gradients_match_jax(name):
    check_ce_gradients(name)


@pytest.mark.parametrize("name", HERE)
def test_adam_step_matches_jax(name):
    check_adam_step(name)


def test_repeatnet_scores_are_normalised_log_probabilities():
    """RepeatNet's `full_scores` are log-probabilities over the vocabulary
    (each row sums to 1 in probability), and its sampled-negative forward
    reads them at the candidate ids."""
    pm = _pmodel("RepeatNet", _jax("RepeatNet")["params"])
    tb = _tb(_batch(0))
    with torch.no_grad():
        logp = pm.full_scores(tb)
        np.testing.assert_allclose(torch.exp(logp).sum(-1).numpy(), 1.0,
                                   atol=1e-5)
        ids = torch.stack([tb["item_id"], tb["item_id"] % 7 + 1], dim=1)
        np.testing.assert_array_equal(
            pm({**tb, "__item_ids__": ids}).numpy(),
            torch.gather(logp, 1, ids.long()).numpy())
