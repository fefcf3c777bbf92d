"""DeepFM's dense-layer operations of every example trained in the window
(forward and backward), as a share of the float32 dense peak the
configuration computes in."""

from benchmark import roofline

UNIT = "%"
MOVES = "train_examples_per_s"


def read(run):
    cfg = run.config
    fields = cfg["num_categorical"] + cfg["num_numeric"]
    flops = run.examples * roofline.deepfm_flops_per_example(
        fields, cfg["embedding_dim"], cfg["hidden_units"])
    peak = roofline.PEAK_FLOPS[cfg["compute_dtype"]]
    return 100.0 * flops / run.window_s / peak
