"""Host milliseconds per traced step inside the program's
``train.latent_disc`` span: a WAE step's phase 1, the latent
discriminator's two forwards, its gradient and its Adam update. None where
the trace holds no such span."""

from portbench import program_spans

UNIT = "ms"
LAYER = "train step"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_images_per_s"
SPAN = "train.latent_disc"


def _traced(ctx) -> bool:
    return ctx.trace is not None and any(
        e["name"] == program_spans.PREFIX + SPAN for e in program_spans.spans(ctx.trace))


def read(ctx):
    if not _traced(ctx):
        return None
    return program_spans.host_ms(ctx, SPAN)
