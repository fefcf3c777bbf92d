"""Kernel B5's share of its roofline in the segment merge: its bytes once
(every score of the per-segment selection and every candidate of the merge
read once, the winners written once) over the HBM rate, divided by B5's
device time."""

from benchmark import kernels, roofline

UNIT = "%"
MOVES = "serve_users_per_s"


def read(run):
    t = run.trace.device_s(kernels.b5)
    if t <= 0:
        return None
    cfg = run.config
    moved = roofline.segmented_select_bytes(
        cfg["num_items"], run.users_per_call, run.k,
        query_chunk=cfg["index"]["query_chunk"])
    return 100.0 * moved / roofline.HBM_BYTES_S * run.calls / t
