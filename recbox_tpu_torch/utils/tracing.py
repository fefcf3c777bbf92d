"""The port's spans, phase markers and counters, in one module.

Spans. ``span(name)`` is a `torch.profiler.record_function` range while a
profiler records (`torch._C._autograd._profiler_enabled()`), and otherwise
one shared null context: no allocation and no dispatcher call. Under the
profiler the ranges stand on the profiler's clock beside CUPTI's device
rows, so a reader of the trace can name an idle gap of the device by the
innermost span open on the host, or intersect a span with the device's busy
intervals. A span's parent is the span it nests in, on one thread. The
operator's exporter is `utils/logging.py` `profile_step`, whose Chrome
trace holds them.

Phases. ``phase(name)`` is ``span(name)`` in an eager step. While the
current CUDA stream captures a graph it also launches a one-thread marker
kernel at the phase's start and end (`csrc/trace_mark.cu`,
``trace_mark<id, 0>`` and ``trace_mark<id, 1>``, ``id`` the phase's index in
`PHASES`). The markers are nodes of the captured graph, so every replay puts
them in the device trace, on the same clock as the kernels between them; a
replay runs no host range. They are captured whatever the profiler's state,
so a replayed step pays for them with tracing off too: two one-thread
kernels a phase. `marker_of` reads a device row's name back to its phase.

Counters. ``counters`` holds every group of counts of the port by name
(``"<module>.<dict>"`` for a kernel wrapper's launch counts, ``"service"``
for the retrieval service's): each group is the dict its module increments,
registered once by `register` when the module is imported, so the module's
attribute and the registry are one object. `training/graph.py` takes back
the counts a capture added to every group and adds them again at each
replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import re
from typing import ContextManager, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

__all__ = ["span", "phase", "PHASES", "marker_of", "prepare_markers",
           "counters", "register"]

# marker id -> phase name; `csrc/trace_mark.cu` instantiates MARKS ids
PHASES: Tuple[str, ...] = (
    "packed::gather", "trainer::forward", "trainer::backward",
    "trainer::adam", "packed::row_update", "sparse::gather",
    "sparse::row_update")
_PHASE_IDS = {name: i for i, name in enumerate(PHASES)}
_MARKER = re.compile(r"\btrace_mark<(\d+), ?(\d+)>")

counters: Dict[str, Dict[str, int]] = {}

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def register(group: str, counts: Dict[str, int]) -> Dict[str, int]:
    """Hold ``counts`` in the registry under ``group`` and return it (the
    same object; a module imported again registers its new dict)."""
    counters[group] = counts
    return counts


def span(name: str) -> ContextManager:
    """A profiler range named ``name`` while a profiler records, else the
    shared null context."""
    return record_function(name) if _profiling() else _NULL


def phase(name: str) -> ContextManager:
    """``span(name)``, and while the current CUDA stream is capturing a
    graph, ``name``'s marker kernels around it."""
    if torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        return _marked(_PHASE_IDS[name], name)
    return span(name)


def marker_of(kernel: str) -> Optional[Tuple[str, int]]:
    """(phase, 0 at its start or 1 at its end) of a marker kernel's name as
    the profiler gives it (``void trace_mark<3, 0>()``); None for any other
    kernel."""
    m = _MARKER.search(kernel)
    return (PHASES[int(m.group(1))], int(m.group(2))) if m else None


@functools.lru_cache(maxsize=None)
def _marker_lib() -> ctypes.CDLL:
    from recbox_tpu_torch.ops import _build
    lib = _build.load("trace_mark")
    lib.recbox_trace_mark.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.recbox_trace_mark.restype = ctypes.c_int
    lib.recbox_trace_mark_count.argtypes = []
    lib.recbox_trace_mark_count.restype = ctypes.c_int
    if lib.recbox_trace_mark_count() < len(PHASES):
        raise RuntimeError(f"csrc/trace_mark.cu instantiates "
                           f"{lib.recbox_trace_mark_count()} marker ids; "
                           f"PHASES has {len(PHASES)}")
    return lib


def _mark(pid: int, end: int) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = _marker_lib().recbox_trace_mark(pid, end, stream)
    if rc != 0:
        raise RuntimeError(f"trace_mark<{pid}, {end}>: launch failed with "
                           f"CUDA error {rc}")


@contextlib.contextmanager
def _marked(pid: int, name: str):
    _mark(pid, 0)
    with span(name):
        yield
    _mark(pid, 1)


def prepare_markers(device) -> None:
    """Build and load the marker kernels and launch each once on
    ``device``, the first time in the process, so that no module is loaded
    while a stream captures. A capture site calls it before it captures."""
    index = torch.device(device).index
    _prepare(torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=None)
def _prepare(index: int) -> None:
    with torch.cuda.device(index):
        for pid in range(len(PHASES)):
            _mark(pid, 0)
            _mark(pid, 1)
