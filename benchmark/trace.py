"""The device trace of a window: `torch.profiler` (CUPTI) over the timed
calls, reduced to device intervals by name, the busy time, and the
breakdown the result line carries.

Spans recorded here come from the benchmark's own files (``bench::*``
ranges around the calls into the program); the program's own
`record_function` ranges are kept as host events too, but a replayed CUDA
graph runs none of them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

Interval = Tuple[str, float, float]     # (name, start s, end s)


def _times(e) -> Tuple[float, float]:
    if hasattr(e, "start_ns"):
        start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
    else:
        start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
    return start, start + dur


def _merge(iv: List[Interval]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for _, s, e in sorted(iv, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """Device and host intervals of one traced window [t0, t1] (profiler
    clock, seconds)."""

    def __init__(self, device: List[Interval], host: List[Interval],
                 t0: float, t1: float):
        self.t0, self.t1 = t0, t1
        self.device = [(n, max(s, t0), min(e, t1)) for n, s, e in device
                       if e > t0 and s < t1]
        self.host = host
        self.busy = _merge(self.device)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the activities whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n))

    def by_name(self) -> List[Tuple[str, float]]:
        sums = {}
        for n, s, e in self.device:
            sums[n] = sums.get(n, 0.0) + (e - s)
        return sorted(sums.items(), key=lambda kv: -kv[1])

    def idle_gaps(self) -> List[Tuple[float, float]]:
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def host_at(self, t: float) -> str:
        """The innermost host event running at ``t`` ("none" outside all)."""
        best = None
        for n, s, e in self.host:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (n, e - s)
        return best[0] if best else "none"

    def breakdown(self, top: int = 10) -> dict:
        """The device activities that took most time, and the longest idle
        gaps named by what the host was doing at their middle."""
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in self.by_name()[:top]],
                "idle_gaps": [[self.host_at((s + e) / 2)[:120], e - s]
                              for s, e in gaps]}


@contextlib.contextmanager
def traced(out: list) -> Iterator[None]:
    """Profile the body; append its `Trace` to ``out`` when it ends. The
    window is the body's own span on the profiler's clock."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        with record_function("bench::window"):
            yield
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = _times(e)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((name, start, end))
        elif name == "bench::window":
            window = (start, end)
        else:
            host.append((name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    # a host range's mirror on the device timeline (a `record_function`
    # name) spans its first kernel to its last, gaps included: not work
    ranges = {n for n, _, _ in host} | {"bench::window"}
    out.append(Trace([d for d in device if d[0] not in ranges], host,
                     *window))


class Phases:
    """Seconds of each named phase of a set-up, each ended by a device
    synchronize (on a CUDA device) so that its work is counted in it."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.t = time.perf_counter()
        self.marks: List[Tuple[str, float]] = []

    def mark(self, name: str) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.marks.append((name, now - self.t))
        self.t = now

    def __str__(self) -> str:
        return ", ".join(f"{n} {s:.3f} s" for n, s in self.marks)


def device_window(run: Callable[[], object], sessions: int = 3
                  ) -> Tuple[object, Optional[Trace]]:
    """``run()`` under the profiler, again up to ``sessions`` times while
    the profiler sees no device work at all (a CUPTI session now and then
    records none); (its last result, its trace)."""
    result, trace = None, None
    for _ in range(sessions):
        traces: list = []
        with traced(traces):
            result = run()
        trace = traces[0]
        if trace.busy_s > 0 or not torch.cuda.is_available():
            break
        time.sleep(0.1)
    return result, trace
