"""The port's examples on the CPU: the one-call cascade, reranking,
streamed shards and the hyperparameter search. Each case runs an
example's ``main(device="cpu")``, whose own ``assert`` (kept from JAX's
script) must hold, and checks what it returns."""

import pytest
import torch

from recbox_tpu_torch.examples import (
    cascade_three_stage, hyper_tuning, rerank_prm, streaming_shards,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the examples take many small steps, and the
    suite's workers share the host's cores (more threads only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cascade_three_stage():
    out = cascade_three_stage.main(device="cpu")
    assert out["stage3_NDCG@5"] > out["list_ranker_NDCG@5"]
    assert set(out) == set(cascade_three_stage.KEYS)


def test_rerank_prm():
    assert rerank_prm.main(device="cpu")["MAP@5"] > 0.8


def test_streaming_shards():
    assert streaming_shards.main(device="cpu")["AUC"] > 0.95


def test_hyper_tuning():
    out = hyper_tuning.main(device="cpu")
    assert out["best_score"] > 0.9
    assert set(out["best_params"]) == {"lr", "width"}
