"""The port's examples on the CPU: the sequential stage, with and without
the flash-CE route (kernel B2's plain version here). Each case runs an
example's ``main(device="cpu")``, whose own ``assert`` (kept from JAX's
script) must hold, and checks what it returns."""

import pytest
import torch

from recbox_tpu_torch.examples import large_vocab_flash_ce, sequential_sasrec
from recbox_tpu_torch.ops import fused_ce


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the examples take many small steps, and the
    suite's workers share the host's cores (more threads only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sequential_sasrec():
    assert sequential_sasrec.main(device="cpu")["test_Recall(k=10)"] > 0.7


def test_large_vocab_flash_ce_takes_the_fused_route():
    calls = []
    real = fused_ce.fused_ce_lse_plain

    def counted(*args, **kw):
        calls.append(True)
        return real(*args, **kw)

    fused_ce.fused_ce_lse_plain = counted
    try:
        out = large_vocab_flash_ce.main(device="cpu")
    finally:
        fused_ce.fused_ce_lse_plain = real
    assert out["test_Recall(k=10)"] > 0.7
    assert calls, "the flash-CE route was not taken"
