"""Device kernels per step in the traced steps (augmentation, the step and
the optimizer), from the profiler."""

UNIT = "kernels"
LAYER = "train step"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.counters.get("traced_steps"):
        return None
    return len(ctx.trace.kernels) / ctx.counters["traced_steps"]
