"""The share of the traced window in which no kernel, copy or memset ran
(``trace.union_us``)."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.window_us())
