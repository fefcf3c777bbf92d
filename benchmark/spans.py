"""The program's own spans and phase markers in a `Trace`: the intervals
they cover, and how much of the device's busy or idle time lies in them.

The program's host spans (`recbox_tpu_torch/utils/tracing.py` ``span``)
are the trace's host events by name; its phase markers are device rows
(``trace_mark<id, 0|1>``), read back to their phase by the program's own
table (`tracing.marker_of`).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

Span = Tuple[float, float]


def merged(intervals: Iterable[Span]) -> List[Span]:
    """The union of ``intervals``, as sorted disjoint intervals."""
    out: List[Span] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_s(a: List[Span], b: List[Span]) -> float:
    """Seconds in both of two lists of sorted disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_spans(trace, name: str) -> List[Span]:
    """The intervals of the host spans named ``name``."""
    return merged((s, e) for n, s, e in trace.host if n == name)


def phase_spans(trace, marker_of: Callable[[str], Optional[tuple]],
                phases: Iterable[str]) -> Tuple[List[Span], List[Span]]:
    """(the device intervals between each start marker of ``phases`` and
    the next end marker of the same phase, the device rows that are no
    marker). A phase whose start or end lies outside the window is left
    out."""
    wanted = set(phases)
    spans, work, open_at = [], [], {}
    for n, s, e in sorted(trace.device, key=lambda d: d[1]):
        mark = marker_of(n)
        if mark is None:
            work.append((s, e))
            continue
        phase, end = mark
        if phase not in wanted:
            continue
        if not end:
            open_at[phase] = e
        elif phase in open_at:
            spans.append((open_at.pop(phase), s))
    return merged(spans), merged(work)
