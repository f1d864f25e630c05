"""Host milliseconds per traced step inside the program's ``train.backward``
span: the backward's segments (``torch.autograd.grad``), whose kernels
autograd's device thread launches while this one waits."""

from portbench import program_spans

UNIT = "ms"
LAYER = "train step"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    return program_spans.host_ms(ctx, "train.backward")
