"""Reading the program's own spans in a traced window: the ``fmri.<name>``
annotations that the program records into the ``torch.profiler`` trace
while a profiler runs (``train.step`` and its phases ``train.forward``,
``train.backward``, ``train.gate``, ``train.optimizer``; ``input.*``).

This is the benchmark's reading, written from the trace format alone: it
imports nothing of the program, so what it measures cannot move with the
program. Every reader returns None on a trace that holds no ``fmri.`` span
(a program without them).

Attribution. A launch or runtime call belongs to the ``fmri.`` spans open
around it on its own thread. The backward's kernels are launched from
autograd's device thread, which records no program span, while the step's
thread waits inside ``train.backward``: a launch that no program span
covers on its own thread goes under the spans open at that moment on the
step's thread (the thread that records ``fmri.train.step``). Blocking
calls count only on their own thread: the benchmark's own synchronizes lie
outside every program span.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, List, Optional

PREFIX = "fmri."
STEP = PREFIX + "train.step"
# the CUDA runtime calls that hold the host until the device has finished
# earlier work (an H100's trace of the training cells shows the first two:
# a pageable host-to-device copy's stream synchronize, the harness's own)
BLOCKING = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")


def spans(trace) -> List[dict]:
    """The program's span events of the trace, every thread."""
    return [e for ops in trace.host.values() for e in ops
            if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]


def step_thread(trace):
    """The thread that records ``fmri.train.step`` most often (None: none)."""
    n = Counter(e["tid"] for e in spans(trace) if e["name"] == STEP)
    return n.most_common(1)[0][0] if n else None


def _program(stack: List[dict]) -> List[str]:
    return [e["name"] for e in stack if e.get("cat") == "user_annotation"
            and e["name"].startswith(PREFIX)]


def launched(trace) -> List[tuple]:
    """(kernel, names of the program spans around its launch) of every
    kernel whose launch the trace holds, attributed as the module says."""
    pairs = [(k, trace._launch(k)) for k in trace.kernels]
    pairs = [(k, l) for k, l in pairs if l is not None]
    own = trace.stacks([(l["tid"], float(l["ts"])) for _, l in pairs])
    names = [_program(st) for st in own]
    main = step_thread(trace)
    if main is not None:
        lost = [i for i, n in enumerate(names) if not n]
        found = trace.stacks([(main, float(pairs[i][1]["ts"])) for i in lost])
        for i, st in zip(lost, found):
            names[i] = _program(st)
    return [(k, n) for (k, _), n in zip(pairs, names)]


def blocking(trace) -> List[dict]:
    """The blocking CUDA runtime calls made inside a program span on their
    own thread."""
    calls = [e for e in trace.timed if e.get("cat") == "cuda_runtime" and e["name"] in BLOCKING]
    stacks = trace.stacks([(e["tid"], float(e["ts"])) for e in calls])
    return [e for e, st in zip(calls, stacks) if _program(st)]


def per_step(ctx, value: Callable) -> Optional[float]:
    """``value(trace)`` over the traced steps; None outside a traced
    training run or where the trace holds no program span."""
    if ctx.kind != "train" or ctx.trace is None or not ctx.counters.get("traced_steps"):
        return None
    if not spans(ctx.trace):
        return None
    return value(ctx.trace) / ctx.counters["traced_steps"]


def host_ms(ctx, name: str) -> Optional[float]:
    """Milliseconds per traced step inside the program span ``fmri.<name>``."""
    full = PREFIX + name
    return per_step(ctx, lambda t: sum(float(e["dur"]) for e in spans(t)
                                       if e["name"] == full) / 1e3)
