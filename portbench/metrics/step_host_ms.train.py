"""Host milliseconds per window step inside the train step's call (forward,
losses, the spliced backward, the gates and RMSprop's per-parameter ops)."""

UNIT = "ms"
LAYER = "train step"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    s = ctx.spans.get("step") if ctx.kind == "train" else None
    return 1e3 * sum(s) / len(s) if s else None
