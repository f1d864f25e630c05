"""Requests per batch in the window, from ``BatchingServer.stats()``."""

UNIT = "rows"
LAYER = "batcher"
SOURCE = "program_counter"
BETTER = "higher"
MOVES = "serve_p95_ms"


def read(ctx):
    if ctx.kind != "serve" or not ctx.counters.get("batches"):
        return None
    return ctx.counters["requests"] / ctx.counters["batches"]
