"""The port's examples on the CPU: matching, serving, evaluation
protocols, knowledge and the one-call surface. Each case runs an
example's ``main(device="cpu")``, whose own ``assert`` (kept from JAX's
script) must hold, and checks what it returns."""

import numpy as np
import pytest
import torch

from recbox_tpu_torch.examples import (
    eval_protocols_and_acquire, knowledge_cke, matching_two_tower,
    one_call_run_experiment, serving_retrieval,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the examples take many small steps, and the
    suite's workers share the host's cores (more threads only contend)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_matching_two_tower():
    out = matching_two_tower.main(device="cpu")
    assert out["HitRate(k=20)"] > 0.7
    assert 0.0 <= out["GiniIndex"] <= 1.0 and out["ItemCoverage"] > 0.0


def test_serving_retrieval():
    out = serving_retrieval.main(device="cpu")
    assert out["in_block"] > 0.8 and out["index_method"] == "exact_sort"
    assert np.asarray(out["swapped_ids"]).max() < 50


def test_eval_protocols_and_acquire():
    out = eval_protocols_and_acquire.main(device="cpu")
    assert set(out) == {"full", "uni50", "pop50"}
    # sampled candidates bound the full-sort metrics from above
    assert out["uni50"]["Recall(k=10)"] >= out["full"]["Recall(k=10)"]


def test_knowledge_cke():
    assert knowledge_cke.main(device="cpu")["Recall(k=20)"] > 0.5


def test_one_call_run_experiment():
    out = one_call_run_experiment.main(device="cpu")
    assert out["BPR"]["Recall(k=10)"] > 0.5
    assert set(out) == {"BPR", "ItemKNN", "FM"}
