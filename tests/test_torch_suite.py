"""Phase 19 of ``chip_smoke.py`` on the CPU: the JAX package's benchmark
suite through the port.

  * its row table (``SUITE_ROWS``) holds ``bench.py``'s ``SUITE`` row for
    row, read with ``ast`` (``bench.py`` is not imported: it drives JAX on a
    TPU): the same names, presets and batches (``BATCH``, or a ``_b<N>``
    suffix), each row on the port's counterpart of its JAX step, and the
    flagship's ``fdb`` variant (``bench.py:46-48,96-97``) beside it;
  * the launches per step of the rows it runs with both kernel flags on,
    counted here as calls of the kernel wrappers (on the card, one launch
    each) at each row's structure: a step's launches depend on its layers
    only, not on its batch or operand dtype, so the rows run at batch 2 and
    the fullbrain row at 64 voxels; ``chip_smoke.SUITE_LAUNCHES`` must equal
    these counts;
  * the phase itself at ``tiny``, with the card's calls stubbed, as a
    rehearsal of its control flow and checks.
"""

import ast
import dataclasses
import importlib.util
import os
import re

import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401

from fmri_tpu_torch.configs import get_config
from fmri_tpu_torch.configs.presets import override_num_voxels
from fmri_tpu_torch.ops import bn, dw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("bn_bwd_reduce", "bn_bwd_apply", "tap_matmul")
# bench.py's measure functions and the paths of phase 19 that stand for them
PATHS = {"_vgan_stage1": "vgan_stage1", "_wae_stage1": "wae_stage1",
         "_wae_vgan_stage1": "wae_vgan", "_vgan_stage2": "vgan_stage2",
         "_vgan_stage3": "vgan_stage3", "_wae_stage2": "wae_stage2",
         "_wae_stage3": "wae_stage3", "_inference_stage3": "inference_stage3",
         "_serving_pipeline": "serving_pipeline"}
# (bn_bwd_reduce, bn_bwd_apply, weight grads) per step of the flags-on rows:
# stage I, the encoder 3 BN and 3 dW, the decoder's two passes 3 BN and 4 dW
# each, the discriminator 3 + 2 + 3 BN and 4 dW (res100's stride-2 first
# conv is one of them); the fullbrain stage II as res64's (fc1 has no kernel
# of its own); WAE I, one encoder and one decoder backward
SUITE_LAUNCHES = {"stage1_vgan_res64_bf16": (17, 17, 15),
                  "stage1_vgan_res100_bf16": (17, 17, 15),
                  "stage2_vgan_fullbrain_bf16": (8, 8, 4),
                  "stage1_wae_res64_bf16_b1024": (6, 6, 7)}


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bench_suite():
    """{name: (measure function, preset, batch)} of bench.py's SUITE, read
    from its source: the flagship's preset is the default of its
    environment override."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    consts = {t.id: node.value for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name)}
    batch = ast.literal_eval(consts["BATCH"])
    rows = {}
    for row in consts["SUITE"].elts:
        name, fn, preset = row.elts
        if isinstance(preset, ast.Call):  # os.environ.get("FMRI_TPU_BENCH_PRESET", default)
            preset = preset.args[1]
        m = re.search(r"_b(\d+)$", name.value)
        rows[name.value] = (fn.id, preset.value, int(m.group(1)) if m else batch)
    return rows


def test_suite_rows_follow_bench_py(smoke):
    bench = _bench_suite()
    assert len(bench) == 15
    want = {name: (PATHS[fn], preset, b) for name, (fn, preset, b) in bench.items()}
    flagship = "stage1_vgan_res64_bf16"
    want[f"{flagship}_variant_fdb"] = ("vgan_stage1_fdb", *want[flagship][1:])
    assert smoke.SUITE_ROWS == want
    assert list(smoke.SUITE_ROWS)[0] == flagship


def test_chip_smoke_checks_the_counted_launches(smoke):
    assert {name: tuple(n[k] for k in KERNELS) for name, n in smoke.SUITE_LAUNCHES.items()
            } == SUITE_LAUNCHES
    assert set(smoke.SUITE_BF16_FP32) <= set(SUITE_LAUNCHES)
    assert all(smoke.SUITE_ROWS[name][1].endswith("-bf16") for name in SUITE_LAUNCHES)


class _Counts:
    """Calls of the BN-backward and weight-grad wrappers (the CPU takes
    their plain versions)."""

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(KERNELS, 0)
        for mod, name, key in ((bn, "bn_bwd_reduce", "bn_bwd_reduce"),
                               (bn, "bn_bwd_apply", "bn_bwd_apply"),
                               (dw, "conv2d_dw", "tap_matmul"),
                               (dw, "conv2d_transpose_dw", "tap_matmul")):
            monkeypatch.setattr(mod, name, self._counted(getattr(mod, name), key))

    def _counted(self, fn, key):
        def call(*args):
            self.n[key] += 1
            return fn(*args)

        return call


@pytest.mark.parametrize("name", sorted(SUITE_LAUNCHES))
def test_kernel_calls_per_step(monkeypatch, smoke, one_torch_thread, name):  # noqa: F811
    path, preset, _ = smoke.SUITE_ROWS[name]
    cfg = get_config(preset)
    if preset.startswith("fullbrain"):
        cfg = override_num_voxels(cfg, 64)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, pallas_bn=True, pallas_backward=True))
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cpu")
    draw = smoke.train_draw(path, cfg, 2, dev, gen, *smoke.suite_data(cfg, 2, dev, gen))
    state = smoke.train_state(path, cfg, smoke.suite_weights(path, cfg), dev)
    counts = _Counts(monkeypatch)
    smoke.train_path(path)[2](cfg)(state, *draw())
    assert tuple(counts.n[k] for k in KERNELS) == SUITE_LAUNCHES[name]


def _launching(fn, counter=None):
    """``fn`` bumping ``counter.launches`` (its own, by default) per call,
    as the wrappers do where they launch their kernels on the card."""
    def call(*args):
        (counter or call).launches += 1
        return fn(*args)

    call.launches = 0
    return call


def _tiny(smoke, preset):
    cfg = get_config("tiny")
    if preset.endswith("-bf16"):
        cfg = smoke.with_flags(cfg, compute_dtype="bfloat16")
    return cfg


def test_suite_phase_runs_at_tiny(monkeypatch, smoke, one_torch_thread):  # noqa: F811
    """Every row at ``tiny`` (batch 4, 8 for the 1,024 rows), the card's
    calls stubbed and the wrappers counted as launches, as the card counts
    them: every check of the phase passes."""
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    for fn in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: 0)
    # torch.profiler's CUDA activity: the step runs, no device time is read
    profiled = []
    monkeypatch.setattr(smoke, "profile_step", lambda run, path, step_s, callers=False: (
        run(), profiled.append((path, callers)), {"device_ms": 0.0, "kernels": 0,
                                                  "busy_share": 0.0, "top": [],
                                                  "by_kernel": {}})[2])
    # the per-call timings: each call is still held against plain; no time is read
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, *a, **k: 1.0)
    monkeypatch.setattr(smoke, "device_ms", lambda fn, *a, **k: (1.0, "stub"))
    for name in ("bn_bwd_reduce", "bn_bwd_apply"):
        monkeypatch.setattr(bn, name, _launching(getattr(bn, name)))
    for name in ("conv2d_dw", "conv2d_transpose_dw"):
        monkeypatch.setattr(dw, name, _launching(getattr(dw, name), dw.tap_matmul))
    monkeypatch.setattr(smoke, "SUITE_ROWS", {
        k: (p, pre, 4 if b == 256 else 8) for k, (p, pre, b) in smoke.SUITE_ROWS.items()})
    launches, numbers = smoke.suite_phase(torch.device("cpu"), "the CPU",
                                          lambda preset: _tiny(smoke, preset))
    assert launches == {f"suite_{name}": dict(zip(KERNELS, n))
                        for name, n in SUITE_LAUNCHES.items()}
    assert set(numbers) == set(smoke.SUITE_ROWS) | {"phase_s"}
    for name in smoke.SUITE_ROWS:
        assert not any(numbers[name]["launches"].values()), name
    for name in smoke.SUITE_PER_CALL:  # every call timed, the weight grads again in fp32
        per_call = numbers[name]["per_call"]
        own, fp32 = (per_call[k]["tap_matmul"]["shapes"] for k in ("own", "fp32"))
        assert len(own) == len(fp32) > 0 and not per_call["fp32"]["bn_bwd_apply"]["shapes"]
        assert {r["dtype"] for r in own} == {"bfloat16"} and {r["dtype"] for r in fp32} == {
            "float32"}
        assert sum(r["count"] for r in own) == SUITE_LAUNCHES[name][2]
        bn_rows = per_call["own"]["bn_bwd_reduce"]["shapes"] + per_call["own"][
            "bn_bwd_apply"]["shapes"]
        assert sum(r["count"] for r in bn_rows) == sum(SUITE_LAUNCHES[name][:2])
        assert all(r["bound_ms"] > 0 and r["share"] == r["bound_ms"] / r["device_ms"]
                   for r in own + fp32 + bn_rows)
        assert {callers for path, callers in profiled if name in path} == {True}
    assert not any(callers for path, callers in profiled
                   if not any(name in path for name in smoke.SUITE_PER_CALL))


def test_elementwise_by_caller_counts_copies(smoke, one_torch_thread):  # noqa: F811
    """The caller breakdown reads a profile's copies (on the CPU no kernel
    is recorded, so no elementwise time)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(4, 8)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True, with_stack=True) as prof:
        x.to(torch.bfloat16)
        x.to(torch.float64)
    out = smoke.elementwise_by_caller(prof, "test")
    assert out["copies"] == 2 and out["elementwise_ms"] == out["copy_ms"] == 0.0
