"""The share of the query rows through the user tower that the service
returns: the program's ``service`` counters (`rows_served` over
`rows_encoded`, the loader's padding counted), cumulative over the run,
whose queries all have the window's shape."""

UNIT = "%"
MOVES = "serve_users_per_s"


def read(run):
    try:
        from recbox_tpu_torch.utils import tracing
    except ImportError:          # a program without the counter registry
        return None
    counts = tracing.counters.get("service", {})
    if not counts.get("rows_encoded"):
        return None
    return 100.0 * counts["rows_served"] / counts["rows_encoded"]
