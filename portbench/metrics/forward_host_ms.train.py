"""Host milliseconds per traced step inside the program's ``train.forward``
span: the encoder, the decodes, the discriminator and the head losses."""

from portbench import program_spans

UNIT = "ms"
LAYER = "train step"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    return program_spans.host_ms(ctx, "train.forward")
