"""Device kernels per traced step whose launch (joined to the kernel by
``correlation``) lies inside the program's ``train.optimizer`` span."""

from portbench import program_spans

UNIT = "kernels"
LAYER = "train step"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    return program_spans.per_step(ctx, lambda t: sum(
        "fmri.train.optimizer" in names for _, names in program_spans.launched(t)))
