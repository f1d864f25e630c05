"""Host milliseconds per ``ServingModel.reconstruct`` call that the batcher
makes in the window (bucket padding, the copy in, the graph, the uint8
pull), from a wrapper around the call."""

UNIT = "ms"
LAYER = "serving model"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "serve_p95_ms"


def read(ctx):
    s = ctx.spans.get("reconstruct") if ctx.kind == "serve" else None
    return 1e3 * sum(s) / len(s) if s else None
