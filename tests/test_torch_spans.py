"""The program's spans (``fmri_tpu_torch/utils/spans.py``) in the stage-I and
stage-II train steps and on the input path, on the CPU at ``tiny``: a shared
no-op without a profiler, nested in order in a CPU profiler's Chrome trace,
and without any effect on what the step computes."""

import copy
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fmri_tpu_torch.configs.presets import get_config
from fmri_tpu_torch.data.pipeline import device_iterator
from fmri_tpu_torch.data.transforms import train_augment
from fmri_tpu_torch.train.optim import RmsProp, exponential_lr
from fmri_tpu_torch.train.state import (
    COGNITIVE_TRAINED, GROUPS, init_cognitive, init_vaegan, make_cognitive_state, make_state,
)
from fmri_tpu_torch.train.steps_vgan import make_vgan_cognitive_step, make_vgan_stage1_step
from fmri_tpu_torch.utils import spans

GATE = (0.35, 0.68, 0.5)  # margin, equilibrium, lambda_mse
CASES = [(1, "spliced"), (1, "naive"), (2, "spliced"), (2, "naive")]
# the spliced backward's segments, in the order they run, in both stages
SEGMENTS = ["discriminator", "decoder", "encoder"]


def _program(stage: int, backward: str):
    """(state, step(state, batch) -> (state, metrics), trained groups) at
    tiny, batch 8, on the CPU: the augmentation, then the stage's step."""
    cfg = get_config("tiny")
    t, b, latent = cfg.train, cfg.train.batch_size, cfg.model.latent_dim
    lr = exponential_lr(t.learning_rate, t.decay_lr, 4)
    gen = torch.Generator().manual_seed(stage)
    noise = [torch.randn(b, latent, generator=gen) for _ in range(3)]
    if stage == 1:
        opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=t.grad_clip)
        state = make_state(init_vaegan(cfg, seed=0), {g: opt for g in GROUPS})
        fn = make_vgan_stage1_step(cfg, lr_schedule=lr, backward=backward).train_step
        flip = torch.rand(b, generator=gen) < 0.5

        def step(state, batch):
            x = train_augment(batch["image"], flip, None)
            return fn(state, x, noise[0], noise[1], *GATE)

        return state, step, GROUPS
    state = make_cognitive_state(init_cognitive(cfg, seed=0), cfg, 2)
    fn = make_vgan_cognitive_step(cfg, 2, lr_schedule=lr, backward=backward).train_step
    shifts = torch.randint(-2, 3, (b, 2), generator=gen)

    def step(state, batch):
        x = train_augment(batch["image"], None, shifts)
        return fn(state, batch["fmri"], x, *noise, *GATE)

    return state, step, COGNITIVE_TRAINED[2]


def _batches(n: int = 1, stage: int = 1):
    """Host batches of uint8 images (and fMRI for stage II) at tiny."""
    cfg = get_config("tiny")
    rng = np.random.default_rng(stage)
    b, s = cfg.train.batch_size, cfg.model.image_size
    return [{"image": rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
             "fmri": rng.normal(size=(b, cfg.model.num_voxels)).astype(np.float32)}
            for _ in range(n)]


def _run(stage, backward, state=None):
    """One step through the input path (staged in the caller's thread):
    (state after, metrics)."""
    init, step, _ = _program(stage, backward)
    state = copy.deepcopy(init if state is None else state)
    batch, = device_iterator(iter(_batches(1, stage)), torch.device("cpu"), prefetch=0)
    return step(state, batch)


def _fmri_events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [e for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith("fmri.")]
    return sorted(out, key=lambda e: (float(e["ts"]), -float(e["dur"])))


def _tree(events):
    """{id(event): [child events in order]} of one thread's spans, and the
    roots, by interval nesting."""
    children, roots, stack = {}, [], []
    for e in events:
        lo = float(e["ts"])
        while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) <= lo:
            stack.pop()
        (children[id(stack[-1])] if stack else roots).append(e)
        children[id(e)] = []
        stack.append(e)
    return children, roots


def _names(events, strip=""):
    return [e["name"][len(strip):] for e in events]


def test_span_is_one_shared_noop_without_a_profiler():
    assert spans.span("train.step") is spans.OFF
    assert spans.span("input.augment") is spans.OFF
    with spans.span("train.forward") as inner:
        assert inner is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("train.step") is not spans.OFF
    assert spans.span("train.step") is spans.OFF


@pytest.mark.parametrize("stage,backward", CASES)
def test_step_records_nothing_without_a_profiler(stage, backward, monkeypatch):
    called = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: called.append(name) or spans.OFF)
    _run(stage, backward)
    assert called == []


@pytest.mark.parametrize("stage,backward", CASES)
def test_step_spans_nest_in_a_cpu_trace(stage, backward, tmp_path):
    """``train.step`` on the caller's thread holds forward, backward, gate
    and optimizer in that order, one ``optimizer.<group>`` per trained
    group; the spliced backward's segments nest in ``train.backward``; the
    input path's spans precede the step."""
    _, _, trained = _program(stage, backward)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(stage, backward)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    events = _fmri_events(path)
    assert {e["tid"] for e in events} == {threading.get_native_id()}
    children, roots = _tree(events)
    assert _names(roots) == ["fmri.input.stage", "fmri.input.augment", "fmri.train.step"]
    phases = children[id(roots[-1])]
    assert _names(phases) == ["fmri.train.forward", "fmri.train.backward", "fmri.train.gate",
                              "fmri.train.optimizer"]
    forward, bwd, gate, opt = phases
    assert children[id(forward)] == [] and children[id(gate)] == []
    assert sorted(_names(children[id(opt)], "fmri.train.optimizer.")) == sorted(trained)
    assert _names(children[id(bwd)], "fmri.train.backward.") == (
        SEGMENTS if backward == "spliced" else [])


@pytest.mark.parametrize("stage,backward", CASES)
def test_step_is_bitwise_the_same_under_the_profiler(stage, backward):
    init, _, _ = _program(stage, backward)
    off_state, off_metrics = _run(stage, backward, init)
    with profile(activities=[ProfilerActivity.CPU]):
        on_state, on_metrics = _run(stage, backward, init)
    assert sorted(off_metrics) == sorted(on_metrics)
    for k in off_metrics:
        assert torch.equal(off_metrics[k], on_metrics[k]), k
    off_sd, on_sd = off_state.nets.state_dict(), on_state.nets.state_dict()
    for k in off_sd:
        assert torch.equal(off_sd[k], on_sd[k]), k
    for g in off_state.opt_state:
        for k in off_state.opt_state[g]:
            assert torch.equal(off_state.opt_state[g][k], on_state.opt_state[g][k]), (g, k)
    assert torch.equal(off_state.step, on_state.step)
    # and the step moved the state
    assert not all(torch.equal(v, init.nets.state_dict()[k]) for k, v in off_sd.items())


def test_input_stage_is_recorded_on_the_producer_thread(tmp_path):
    """A profiler that records every thread shows each batch's
    ``input.stage`` on ``device_iterator``'s producer thread."""
    from torch._C._profiler import _ExperimentalConfig

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        got = list(device_iterator(iter(_batches(3)), torch.device("cpu"), prefetch=2))
    assert len(got) == 3
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    staged = [e for e in _fmri_events(path) if e["name"] == "fmri.input.stage"]
    assert len(staged) == 3
    assert {e["tid"] for e in staged} != {threading.get_native_id()}
