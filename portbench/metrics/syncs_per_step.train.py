"""CUDA runtime calls per traced step that hold the host until the device
is done (``program_spans.BLOCKING``), made inside a program span on their
own thread."""

from portbench import program_spans

UNIT = "calls"
LAYER = "train step"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    return program_spans.per_step(ctx, lambda t: len(program_spans.blocking(t)))
