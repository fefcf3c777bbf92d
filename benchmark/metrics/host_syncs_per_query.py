"""The sites at which the host waited on the card in one query: the
program's ``service`` counters (`host_waits` over `queries`: each
synchronous copy of a batch to the card, each select of its real rows,
each wait for the results), cumulative over the run, whose queries all
have the window's shape."""

UNIT = "count"
MOVES = "serve_users_per_s"


def read(run):
    try:
        from recbox_tpu_torch.utils import tracing
    except ImportError:          # a program without the counter registry
        return None
    counts = tracing.counters.get("service", {})
    if not counts.get("queries"):
        return None
    return counts["host_waits"] / counts["queries"]
