"""The share of the traced training window in which no kernel or copy ran
on the device."""

UNIT = "%"
MOVES = "train_examples_per_s"


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.busy_s > 0 else None
