"""Device time a training step of the packed trainer's own work: B1, the
gather of the pack rows and the copies (`kernels.packed_path`)."""

from benchmark import kernels

UNIT = "ms"
MOVES = "train_examples_per_s"


def read(run):
    ms = run.trace.device_s(kernels.packed_path) * 1e3
    return ms / run.steps if ms > 0 and run.steps else None
