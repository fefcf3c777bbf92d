"""Device idle time inside the program's query calls, a call: the idle
gaps of the traced window (`Trace.idle_gaps`) that lie inside the
program's ``service::query`` spans, over the window's calls. The rest of
the window's idle time is the harness's loop between calls."""

from benchmark import spans

UNIT = "ms"
MOVES = "serve_users_per_s"


def read(run):
    queries = spans.host_spans(run.trace, "service::query")
    if not queries or not run.calls:
        return None
    idle = spans.overlap_s(run.trace.idle_gaps(), queries)
    return idle * 1e3 / run.calls
