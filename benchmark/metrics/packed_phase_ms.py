"""Device time a training step inside the packed trainer's own phases: the
device's busy time between each replayed step's ``packed::gather``
markers and between its ``packed::row_update`` markers (the program's
phase markers, read by its own table), the markers left out, over the
window's steps. None where the trace holds no markers."""

from benchmark import spans

UNIT = "ms"
MOVES = "train_examples_per_s"
PHASES = ("packed::gather", "packed::row_update")


def read(run):
    try:
        from recbox_tpu_torch.utils.tracing import marker_of
    except ImportError:          # a program without phase markers
        return None
    phases, work = spans.phase_spans(run.trace, marker_of, PHASES)
    if not phases or not run.steps:
        return None
    return spans.overlap_s(work, phases) * 1e3 / run.steps
