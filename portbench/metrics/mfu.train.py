"""The whole step's share of the card's peak: the model's FLOP per step
(``counts.step_ops``, forward and backward of every conv, transposed conv and
linear the step needs, no recompute) times the window's steps, over the
window's seconds and 989 TFLOP/s (bf16 dense, 700 W)."""

from portbench.peaks import PEAK_BF16_FLOPS

UNIT = "%"
LAYER = "whole step"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "train_images_per_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.counters.get("window_s"):
        return None
    flops = ctx.counters["model_flops"] * ctx.counters["steps"]
    return 100.0 * flops / ctx.counters["window_s"] / PEAK_BF16_FLOPS
