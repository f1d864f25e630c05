"""The share of the traced window in which no kernel, copy or memset ran."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "serve_p95_ms"


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.window_us())
