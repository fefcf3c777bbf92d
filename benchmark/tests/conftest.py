"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
repository root. Tests marked ``card`` run a cell at its own size and need
a CUDA device; each decides inside the test whether one is there."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    """Skip the test unless a CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100 the cells run on)")
    return "cuda"
