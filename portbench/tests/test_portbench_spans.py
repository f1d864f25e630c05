"""The readers of the program's spans (``program_spans.py`` and the metrics
that use it) on a hand-built Chrome trace of two steps: nested ``fmri.``
spans on the step's thread, kernels joined to their launches by
``correlation``, a launch from autograd's thread while the step's thread
waits inside ``train.backward``, another while it is inside
``train.optimizer``, and blocking calls inside and outside program spans."""

from __future__ import annotations

import json

import pytest

from portbench import harness, program_spans
from portbench.trace import Trace

MAIN, AUTOGRAD, PRODUCER = 101, 102, 103
STEP_US = 1000.0
NEW = ("forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train",
       "optimizer_launches_per_step.train", "syncs_per_step.train", "sync_wait_ms.train")


def _step(t0: float, corr0: int, prefix: str = "fmri.") -> list:
    """One step's events from ``t0`` (us), correlations from ``corr0``."""
    ev = []
    corr = iter(range(corr0, corr0 + 100))

    def span(name, ts, dur, tid=MAIN):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
                   "ts": t0 + ts, "dur": dur})

    def launch(ts, tid=MAIN, kernel_dur=5.0):
        c = next(corr)
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
                   "ts": t0 + ts, "dur": 2, "args": {"correlation": c}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{c}", "tid": 7, "ts": t0 + ts + 10,
                   "dur": kernel_dur, "args": {"correlation": c}})

    def call(name, ts, dur, tid=MAIN):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid, "ts": t0 + ts,
                   "dur": dur, "args": {"correlation": next(corr)}})

    span("portbench.step", 0, 990)
    span(prefix + "train.step", 10, 900)
    span(prefix + "train.forward", 20, 100)
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::convolution", "tid": MAIN,
               "ts": t0 + 30, "dur": 10})
    launch(35, kernel_dur=20.0)
    span(prefix + "train.backward", 150, 300)
    span(prefix + "train.backward.discriminator", 160, 100)
    launch(200, tid=AUTOGRAD, kernel_dur=50.0)  # the step's thread waits in backward
    call("cudaMemcpyAsync", 300, 3, tid=PRODUCER)
    call("cudaStreamSynchronize", 320, 5, tid=PRODUCER)  # in no span on its own thread
    span(prefix + "train.gate", 460, 100)
    call("cudaStreamSynchronize", 470, 60)  # blocks inside the gate
    span(prefix + "train.optimizer", 600, 250)
    span(prefix + "train.optimizer.encoder", 610, 100)
    launch(620)
    launch(640)
    launch(650, tid=AUTOGRAD)  # uncovered on its thread: the step thread's optimizer
    span(prefix + "train.optimizer.decoder", 720, 100)
    launch(730)
    call("cudaDeviceSynchronize", 950, 30)  # the benchmark's, outside program spans
    return ev


def _ctx(tmp_path, prefix="fmri.", kind="train") -> harness.Context:
    events = _step(0.0, 1, prefix) + _step(STEP_US, 1001, prefix)
    events.append({"ph": "M", "name": "process_name", "pid": 1})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ctx = harness.Context(kind)
    ctx.trace = Trace(str(path))
    ctx.counters["traced_steps"] = 2
    return ctx


@pytest.fixture(scope="module")
def readers():
    return harness.readers()


def test_readers_give_exact_values(tmp_path, readers):
    ctx = _ctx(tmp_path)
    got = {name: readers[name].read(ctx) for name in NEW}
    assert got == {
        "forward_host_ms.train": pytest.approx(0.1),
        "backward_host_ms.train": pytest.approx(0.3),
        "optimizer_host_ms.train": pytest.approx(0.25),
        "optimizer_launches_per_step.train": 4,
        "syncs_per_step.train": 1,
        "sync_wait_ms.train": pytest.approx(0.06),
    }


def test_launches_are_attributed_to_the_step_threads_spans(tmp_path):
    ctx = _ctx(tmp_path)
    assert program_spans.step_thread(ctx.trace) == MAIN
    by_kernel = {k["name"]: names for k, names in program_spans.launched(ctx.trace)}
    assert by_kernel["k1"] == ["fmri.train.step", "fmri.train.forward"]
    # autograd's launch while the step waits in the backward's first segment
    assert by_kernel["k2"] == ["fmri.train.step", "fmri.train.backward",
                               "fmri.train.backward.discriminator"]
    assert by_kernel["k8"] == ["fmri.train.step", "fmri.train.optimizer",
                               "fmri.train.optimizer.encoder"]
    blocked = program_spans.blocking(ctx.trace)
    assert [(e["name"], e["tid"]) for e in blocked] == [("cudaStreamSynchronize", MAIN)] * 2


@pytest.mark.parametrize("prefix,kind", [("other.", "train"), ("fmri.", "serve")])
def test_readers_give_none_without_program_spans(tmp_path, readers, prefix, kind):
    ctx = _ctx(tmp_path, prefix, kind)
    assert {name: readers[name].read(ctx) for name in NEW} == dict.fromkeys(NEW)
    untraced = harness.Context("train")
    assert {name: readers[name].read(untraced) for name in NEW} == dict.fromkeys(NEW)
