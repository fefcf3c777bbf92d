"""Kernel B3's share of its roofline: the bound of every call (2·Q·N·D
operations at the bf16 peak, or the corpus, queries and results once at
the HBM rate, whichever is larger) over B3's kernels' device time."""

from benchmark import kernels, roofline

UNIT = "%"
MOVES = "serve_users_per_s"


def read(run):
    t = run.trace.device_s(kernels.b3)
    if t <= 0:
        return None
    cfg = run.config
    bound, _ = roofline.mips_topk_bound_s(
        cfg["num_items"], cfg["embedding_dim"], run.users_per_call, run.k,
        "bfloat16")
    return 100.0 * bound * run.calls / t
