"""The served users' model operations (the user tower's MLP and the dot
product with every item, 2·N·D) over the window, as a share of the bf16
dense peak."""

from benchmark import roofline

UNIT = "%"
MOVES = "serve_users_per_s"


def read(run):
    cfg = run.config
    flops = run.users * roofline.serve_flops_per_user(
        cfg["num_items"], cfg["embedding_dim"], cfg["hidden_units"])
    return 100.0 * flops / run.window_s / roofline.PEAK_FLOPS["bfloat16"]
