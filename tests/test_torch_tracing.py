"""The port's tracing (`recbox_tpu_torch/utils/tracing.py`) on the CPU.

Spans and phases cost nothing without a profiler (the shared null context)
and are profiler ranges under one; a query of `RetrievalService` emits its
spans nested as the service's layers nest, its ``index::`` span named by
the route the search takes; the service's counters count the query's rows
(the loader's padding included) and nothing of the corpus encode; the
registry holds the kernel wrappers' own dicts, and `kernel_counters` reads
every group of it. The marker kernels of a captured step run only on the
card (`benchmark/tests/test_bench_tracing_metrics.py`).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.ops import (
    bitonic_topk, embedding_gather, fused_ce, mips_fused_topk, mips_topk,
    packed_delta,
)
from recbox_tpu_torch.ops.losses import binary_crossentropy
from recbox_tpu_torch.retrieval import RetrievalService
from recbox_tpu_torch.retrieval import service as service_mod
from recbox_tpu_torch.training import (
    PackedEmbeddingTrainer, Trainer, TrainerConfig,
)
from recbox_tpu_torch.training.graph import kernel_counters
from recbox_tpu_torch.utils import tracing

PORT = Path(__file__).resolve().parents[1] / "recbox_tpu_torch"
DIM = 8

# the serving spans and the span each nests in (None: the outermost)
PARENT = {"service::query": None,
          "service::encode": "service::query",
          "service::load": "service::encode",
          "service::to_device": "service::encode",
          "service::tower": "service::encode",
          "service::select": "service::encode",
          "service::to_host": "service::query",
          "service::merge_interests": "service::query",
          "service::exclude": "service::query"}

GROUPS = [(bitonic_topk, "launches"), (bitonic_topk, "stream_launches"),
          (bitonic_topk, "large_launches"),
          (mips_fused_topk, "launches"), (mips_fused_topk, "stream_launches"),
          (mips_fused_topk, "large_launches"),
          (mips_topk, "launches"), (mips_topk, "route_launches"),
          (packed_delta, "launches"), (fused_ce, "launches"),
          (embedding_gather, "launches")]


class _Towers(nn.Module):
    """Two tables as towers; with ``interests`` the user tower returns
    (B, interests, D), as a multi-interest model does."""

    def __init__(self, n_users, n_items, interests=0):
        super().__init__()
        gen = torch.Generator().manual_seed(3)
        width = max(interests, 1)
        self.users = nn.Parameter(torch.randn(n_users, width, DIM,
                                              generator=gen))
        self.items = nn.Parameter(torch.randn(n_items, DIM, generator=gen))
        self.interests = interests

    def encode_user(self, batch):
        u = self.users[batch["user_id"].long()]
        return u if self.interests else u[:, 0]

    def encode_item(self, batch):
        return self.items[batch["item_id"].long()]


def _service(n_users=300, n_items=2000, interests=0, **kw):
    model = _Towers(n_users, n_items, interests)
    return RetrievalService(
        model, {"item_id": np.arange(n_items, dtype=np.int64)},
        device="cpu", **kw)


def _users(n):
    return {"user_id": np.arange(n, dtype=np.int64)}


def _ranges(prof):
    """(name, start ns, end ns) of the profile's host ranges."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _ranges(prof)


def _innermost_parent(ranges, child, names):
    """The innermost range among ``names`` that holds ``child``."""
    _, s, e = child
    holders = [r for r in ranges if r[0] in names and r is not child
               and r[1] <= s and e <= r[2]]
    return min(holders, key=lambda r: r[2] - r[1])[0] if holders else None


def _ctr_trainer():
    specs = tuple(FeatureSpec(f"c{i}", "categorical", vocab_size=64,
                              embedding_dim=DIM) for i in range(3)) + (
        FeatureSpec("n0", "numeric", embedding_dim=DIM),)
    model = DeepFM(FeatureMap("t", specs, labels=("click",)), device="cpu",
                   embedding_dim=DIM, hidden_units=(16,))
    return model, lambda o, b: binary_crossentropy(o, b["click"])


def _ctr_batch(seed=0, b=128):
    rng = np.random.default_rng(seed)
    batch = {f"c{i}": rng.integers(0, 64, b).astype(np.int32)
             for i in range(3)}
    batch["n0"] = rng.normal(size=b).astype(np.float32)
    batch["click"] = (batch["c0"] % 2).astype(np.float32)
    return batch


# -- spans and phases off and on ----------------------------------------------
def test_off_spans_and_phases_are_the_shared_null_and_record_nothing():
    assert not torch._C._autograd._profiler_enabled()
    ctxs = [tracing.span("test::early"), tracing.span("test::other"),
            tracing.phase("trainer::forward"),
            tracing.phase("packed::row_update")]
    assert all(c is ctxs[0] for c in ctxs)
    for c in ctxs:
        with c:
            torch.ones(2).sum()
    ranges = _profiled(lambda: torch.ones(3).sum())
    names = {n for n, _, _ in ranges}
    assert not names & {"test::early", "test::other", "trainer::forward",
                        "packed::row_update"}, names


def test_span_under_a_profiler_is_a_range_of_its_name():
    def body():
        with tracing.span("test::outer"):
            with tracing.span("test::inner"):
                torch.ones(4).sum()
    ranges = _profiled(body)
    inner = next(r for r in ranges if r[0] == "test::inner")
    assert _innermost_parent(ranges, inner,
                             {"test::outer"}) == "test::outer"


def test_phase_table_and_marker_names():
    assert len(set(tracing.PHASES)) == len(tracing.PHASES)
    src = (PORT / "csrc" / "trace_mark.cu").read_text()
    marks = int(src.split("constexpr int MARKS = ")[1].split(";")[0])
    assert len(tracing.PHASES) <= marks
    for pid, name in enumerate(tracing.PHASES):
        for end in (0, 1):
            assert tracing.marker_of(
                f"void trace_mark<{pid}, {end}>()") == (name, end)
    assert tracing.marker_of("void select_topk<4, 32, WinnerOut>()") is None


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_eager_step_phases_under_a_profiler(packed):
    """An eager step's phases are profiler ranges, in the step's order."""
    model, loss = _ctr_trainer()
    cls = PackedEmbeddingTrainer if packed else Trainer
    trainer = cls(model, loss, TrainerConfig(learning_rate=1e-2,
                                             monitor="AUC"), device="cpu")
    batch = _ctr_batch()
    trainer.train_step(batch)
    ranges = _profiled(lambda: trainer.train_step(_ctr_batch(1)))
    order = [n for n, _, _ in sorted(ranges, key=lambda r: r[1])
             if n in tracing.PHASES]
    want = ["trainer::forward", "trainer::backward", "trainer::adam"]
    if packed:
        want = ["packed::gather"] + want + ["packed::row_update"]
    assert order == want


def test_every_phase_of_the_port_has_a_marker_id():
    """A phase name outside `PHASES` would raise only while a card's stream
    captures; every ``tracing.phase("...")`` of the port is in the table."""
    used = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "phase" and node.args \
                    and isinstance(node.args[0], ast.Constant):
                used.add(node.args[0].value)
    assert {"packed::gather", "packed::row_update", "sparse::gather",
            "sparse::row_update", "trainer::forward", "trainer::backward",
            "trainer::adam"} == used
    assert used <= set(tracing.PHASES)


def test_no_profiler_range_outside_the_tracing_module():
    """Every span and phase of the port goes through `utils/tracing.py`;
    `utils/logging.py` `profile_step` is the exporter."""
    for path in PORT.rglob("*.py"):
        if path.name == "tracing.py" and path.parent.name == "utils":
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith("torch.profiler"):
                names = {a.name for a in node.names}
                assert "record_function" not in names, path
                assert path.name == "logging.py", (path, names)
            if isinstance(node, ast.Attribute):
                assert node.attr != "record_function", path


# -- the serving spans -------------------------------------------------------
@pytest.mark.parametrize("kw, n_items, k, route", [
    ({}, 8000, 5, "fused"),
    ({"quantize": "int8"}, 8000, 5, "fused"),
    ({}, 6000, 300, "segmented"),
    ({"method": "approx"}, 2000, 5, "approx"),
    ({"method": "exact"}, 2000, 5, "exact_sort"),
    ({"method": "refined"}, 2000, 5, "refined"),
    ({"quantize": "int8", "method": "approx"}, 2000, 5, "int8"),
    ({}, 2000, 600, "chunked"),
], ids=["fused", "fused_int8", "segmented", "approx", "exact_sort",
        "refined", "int8", "chunked"])
def test_query_spans_nest_and_name_the_route(kw, n_items, k, route):
    svc = _service(n_items=n_items, **kw)
    assert svc.index._route(min(k, svc.num_items)) == route
    ranges = _profiled(lambda: svc.query(_users(40), k=k))
    names = {n for n, _, _ in ranges}
    index = f"index::{route}"
    assert {index} == {n for n in names if n.startswith("index::")}
    spans = set(PARENT) - {"service::merge_interests", "service::exclude"}
    assert spans <= names, spans - names
    parents = dict(PARENT, **{index: "service::query"})
    for r in ranges:
        if r[0] in parents:
            assert _innermost_parent(ranges, r, set(parents)) \
                == parents[r[0]], r[0]


@pytest.mark.parametrize("case", ["merge_interests", "exclude"])
def test_query_spans_of_the_host_rerank(case):
    svc = _service(interests=3 if case == "merge_interests" else 0)
    kw = {"exclude": [[0, 1]] * 20} if case == "exclude" else {}
    ranges = _profiled(lambda: svc.query(_users(20), k=5, **kw))
    span = f"service::{case}"
    hit = [r for r in ranges if r[0] == span]
    assert len(hit) == 1
    assert _innermost_parent(ranges, hit[0], set(PARENT)) == "service::query"


# -- the service's counters --------------------------------------------------
@pytest.mark.parametrize("users, batch, encoded", [
    (100, 256, 256), (300, 256, 512), (256, 256, 256)])
def test_query_counts_rows_through_the_padded_batch(users, batch, encoded):
    counts = service_mod.query_counts
    before = dict(counts)
    svc = _service(batch_size=batch)
    assert counts == before            # the corpus encode counts nothing
    s, i = svc.query(_users(users), k=5)
    assert s.shape == (users, 5)
    moved = {key: counts[key] - before[key] for key in counts}
    # no CUDA device here: the host waits on none
    assert moved == {"queries": 1, "rows_encoded": encoded,
                     "rows_served": users, "host_waits": 0}


def test_service_counts_are_a_registry_group():
    assert tracing.counters["service"] is service_mod.query_counts
    assert set(service_mod.query_counts) == {
        "queries", "rows_encoded", "rows_served", "host_waits"}


# -- the registry -------------------------------------------------------------
@pytest.mark.parametrize("module, attr", GROUPS,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}.{a}"
                              for m, a in GROUPS])
def test_registry_groups_are_the_module_attributes(module, attr):
    group = f"{module.__name__.rsplit('.', 1)[1]}.{attr}"
    assert tracing.counters[group] is getattr(module, attr)


def test_kernel_counters_read_every_registered_group():
    read = kernel_counters()
    assert len(read) == len(tracing.counters)
    assert all(any(c is g for c in read) for g in tracing.counters.values())
    for module, attr in GROUPS:
        assert any(c is getattr(module, attr) for c in read), attr


def test_register_returns_the_same_dict():
    counts = {"n": 0}
    try:
        assert tracing.register("test.group", counts) is counts
        assert tracing.counters["test.group"] is counts
    finally:
        del tracing.counters["test.group"]
