"""Kernel B1's share of its roofline: the bytes that each step's ids need
(per gathered row its id and accumulators, its gradients; per distinct row
the used columns read and written once) over the HBM rate, summed over the
window's steps, divided by B1's device time."""

from benchmark import kernels, roofline

UNIT = "%"
MOVES = "train_examples_per_s"


def read(run):
    t = run.trace.device_s(kernels.b1)
    if t <= 0:
        return None
    cfg = run.config
    dims = (cfg["embedding_dim"], 1)
    grad_bytes = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    bound = sum(roofline.b1_bound_s(run.ids_per_step, run.unique_rows(b),
                                    dims, grad_bytes)[0]
                for b in run.step_batches)
    return 100.0 * bound / t
