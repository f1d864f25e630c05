"""Milliseconds per window step that the loop waits on ``device_iterator``'s
next batch (the producer thread's gather, pin and copy)."""

UNIT = "ms"
LAYER = "host input"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    w = ctx.spans.get("input_wait") if ctx.kind == "train" else None
    return 1e3 * sum(w) / len(w) if w else None
