"""The caching allocator's peak over the window (``max_memory_allocated``
after a reset at its start)."""

UNIT = "MiB"
LAYER = "device"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "train_images_per_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.counters.get("peak_window_bytes"):
        return None
    return ctx.counters["peak_window_bytes"] / 2**20
