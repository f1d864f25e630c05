"""Milliseconds per window step that Python's garbage collector held the
process, all generations, over the whole window (``gc.callbacks``): the
host stalls a step's dispatch waits behind."""

UNIT = "ms"
LAYER = "train step"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    c = ctx.counters
    if ctx.kind != "train" or "gc_s" not in c or not c.get("steps"):
        return None
    return 1e3 * c["gc_s"] / c["steps"]
