"""Host milliseconds per traced step spent in the blocking calls that
``syncs_per_step.train`` counts."""

from portbench import program_spans

UNIT = "ms"
LAYER = "train step"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    return program_spans.per_step(ctx, lambda t: sum(
        float(e["dur"]) for e in program_spans.blocking(t)) / 1e3)
