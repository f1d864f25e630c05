"""The 95th percentile of how late the load generator sent a request (sent
minus due): where it is large the generator, which shares the interpreter
lock with the batcher, set the tail."""

UNIT = "ms"
LAYER = "load generator"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = "serve_p95_ms"


def read(ctx):
    lag = ctx.counters.get("lag_p95_s") if ctx.kind == "serve" else None
    return None if lag is None else 1e3 * lag
