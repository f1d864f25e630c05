"""The least time of the traced steps' convs, transposed convs and linears
(``counts.step_ops``: forward, data grad and weight grad from the shapes, at
the compute dtype's peak or the memory rate) over the device time of the
kernels launched under ``aten::convolution``, ``aten::convolution_backward``,
``aten::mm``, ``aten::addmm`` and ``aten::linear`` in them."""

OPS = ("aten::convolution", "aten::convolution_backward", "aten::mm", "aten::addmm",
       "aten::linear")

UNIT = "%"
LAYER = "kernels"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "train_images_per_s"


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.counters.get("traced_steps"):
        return None
    device_s = ctx.trace.kernel_seconds_under(OPS)
    if device_s <= 0:
        return None
    return 100.0 * ctx.counters["least_s"] * ctx.counters["traced_steps"] / device_s
