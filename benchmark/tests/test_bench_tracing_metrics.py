"""The readers of the program's spans, phase markers and counters
(`query_idle_ms`, `packed_phase_ms`, `encode_useful_share`,
`host_syncs_per_query`) on hand-built traces and counts, a program without
them, and, on the card, the markers of a replayed step and the host's waits
of a query against `torch.cuda.set_sync_debug_mode`."""

import sys
import warnings
from types import SimpleNamespace

import pytest
import torch

from benchmark.spec import Spec, load_module
from benchmark.trace import Trace

SPEC = Spec()
MARK = "void trace_mark<{}, {}>()"
GATHER, ROW_UPDATE, FORWARD = 0, 4, 1        # ids in `tracing.PHASES`


def _reader(name):
    return load_module(SPEC.metric_path(name))


def _run(trace, **kw):
    return SimpleNamespace(trace=trace, **kw)


def test_query_idle_counts_only_idle_time_inside_query_spans():
    # device busy 0-1, 3-4, 6-10; queries 0.5-4.5 and 5-7; harness 8-9
    device = [("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 6.0, 10.0)]
    host = [("service::query", 0.5, 4.5), ("service::query", 5.0, 7.0),
            ("bench::query", 0.4, 4.6), ("cudaStreamSynchronize", 8.0, 9.0)]
    trace = Trace(device, host, 0.0, 10.0)
    # idle 1-3 and 4-4.5 in the first query, 5-6 in the second; 4.5-5 lies
    # between the two
    value = _reader("query_idle_ms").read(_run(trace, calls=2))
    assert value == pytest.approx((2.0 + 0.5 + 1.0) * 1e3 / 2)


def test_query_idle_is_none_without_query_spans():
    trace = Trace([("k", 0.0, 1.0)], [("bench::query", 0.0, 2.0)], 0.0, 2.0)
    assert _reader("query_idle_ms").read(_run(trace, calls=1)) is None


def test_packed_phase_sums_only_device_rows_between_a_phases_markers():
    device = [
        # step 1: gather 1.0-2.0 (a kernel 1.2-1.5), forward (not read),
        # row update 4.0-5.0 (kernels 4.1-4.4 and 4.3-4.6, overlapping)
        (MARK.format(GATHER, 0), 0.9, 1.0), ("gather", 1.2, 1.5),
        (MARK.format(GATHER, 1), 2.0, 2.1),
        (MARK.format(FORWARD, 0), 2.1, 2.2), ("gemm", 2.3, 3.8),
        (MARK.format(FORWARD, 1), 3.8, 3.9),
        (MARK.format(ROW_UPDATE, 0), 3.9, 4.0), ("b1", 4.1, 4.4),
        ("b1b", 4.3, 4.6), (MARK.format(ROW_UPDATE, 1), 5.0, 5.1),
        # work outside every read phase: the staging of the next batches
        ("copy", 5.2, 6.0),
        # step 2's gather opens but the window ends first
        (MARK.format(GATHER, 0), 6.1, 6.2), ("gather", 6.3, 6.9)]
    trace = Trace(device, [], 0.0, 7.0)
    value = _reader("packed_phase_ms").read(_run(trace, steps=1))
    assert value == pytest.approx((0.3 + 0.5) * 1e3)


def test_packed_phase_is_none_without_markers():
    trace = Trace([("gather", 0.0, 1.0), ("b1", 1.0, 2.0)], [], 0.0, 2.0)
    assert _reader("packed_phase_ms").read(_run(trace, steps=4)) is None


@pytest.fixture
def service_counts(monkeypatch):
    from recbox_tpu_torch.utils import tracing
    counts = {"queries": 3, "rows_encoded": 3 * 8192,
              "rows_served": 3 * 1024, "host_waits": 15}
    monkeypatch.setitem(tracing.counters, "service", counts)
    return counts


def test_counter_readers_read_the_registry(service_counts):
    run = _run(None)
    assert _reader("encode_useful_share").read(run) == 12.5
    assert _reader("host_syncs_per_query").read(run) == 5.0


@pytest.mark.parametrize("name", ["query_idle_ms", "encode_useful_share",
                                  "host_syncs_per_query", "packed_phase_ms"])
def test_readers_return_none_for_a_program_without_tracing(name,
                                                           monkeypatch):
    """The parent commit's program has no `utils/tracing.py`, no spans and
    no markers: each reader returns None there and raises nothing."""
    import recbox_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "recbox_tpu_torch.utils.tracing", None)
    trace = Trace([("gather", 0.0, 1.0)], [("bench::query", 0.0, 1.0)],
                  0.0, 1.0)
    assert _reader(name).read(_run(trace, calls=1, steps=1)) is None


# -- on the card -------------------------------------------------------------
@pytest.mark.card
def test_replayed_steps_carry_the_phase_markers(card):
    """A cell's training at a small size on the card: every replayed step
    of the window's trace holds each phase's two markers, `packed_phase_ms`
    reads them, and B1's launches count at every replay."""
    from benchmark import trace as tr
    from benchmark.tests.sizes import small
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.utils import tracing
    name = "deepfm-criteo.zipf"
    cfg, traffic = small(SPEC, name)
    system = load_module(SPEC.system_path(cfg))
    st = system.setup(cfg, traffic, 11, card,
                      load_module(SPEC.reference_path(cfg)))
    before = packed_delta.launches["packed_adagrad_update"]
    win, trace = tr.device_window(lambda: system.window(st, 0.5))
    assert packed_delta.launches["packed_adagrad_update"] - before \
        == win["steps"]
    marks = [tracing.marker_of(n) for n, _, _ in trace.device]
    for phase in ("packed::gather", "trainer::forward", "trainer::backward",
                  "trainer::adam", "packed::row_update"):
        for end in (0, 1):
            assert abs(marks.count((phase, end)) - win["steps"]) <= 1
    run = _run(trace, steps=win["steps"])
    assert _reader("packed_phase_ms").read(run) > 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["youtubednn-1m.batch-k500",
                                  "youtubednn-1m.cascade-k10000"])
def test_host_waits_match_the_sync_debug_mode(card, name):
    """One query of a serving cell at a small size: the service counts as
    many waits of the host as `torch.cuda.set_sync_debug_mode('warn')`
    reports."""
    from benchmark.tests.sizes import small
    from recbox_tpu_torch.retrieval.service import query_counts
    cfg, traffic = small(SPEC, name)
    system = load_module(SPEC.system_path(cfg))
    st = system.setup(cfg, traffic, 11, card,
                      load_module(SPEC.reference_path(cfg)))
    query = {k: v[0] for k, v in st.pool.items()}
    before = query_counts["host_waits"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            st.svc.query(query, k=traffic["k"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert query_counts["host_waits"] - before == len(syncs), \
        [str(w.message) for w in syncs]
