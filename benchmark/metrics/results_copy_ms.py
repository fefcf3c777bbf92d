"""Device time of the results' copy to the host a query call (the
service's ``_to_host``), from the trace's device-to-host memcpy rows."""

from benchmark import kernels

UNIT = "ms"
MOVES = "serve_users_per_s"


def read(run):
    ms = run.trace.device_s(kernels.to_host) * 1e3
    return ms / run.calls if ms > 0 and run.calls else None
