"""Device kernels per traced step whose launch (joined to the kernel by
``correlation``) lies inside the program's ``train.latent_disc`` span, its
Adam update included. None where the trace holds no such span."""

from portbench import program_spans

UNIT = "kernels"
LAYER = "train step"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_images_per_s"
SPAN = "train.latent_disc"


def _traced(ctx) -> bool:
    return ctx.trace is not None and any(
        e["name"] == program_spans.PREFIX + SPAN for e in program_spans.spans(ctx.trace))


def read(ctx):
    if not _traced(ctx):
        return None
    return program_spans.per_step(ctx, lambda t: sum(
        program_spans.PREFIX + SPAN in names for _, names in program_spans.launched(t)))
