"""Whole runs of the harness: without a card it refuses; at the tiny widths
on the CPU nothing it runs loads JAX or the JAX package; with the timed path
broken underneath, or with the reference one precision down in the
program's place, ``correct`` comes out false; on the card a cell runs."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, last_result, run_cell, tiny_bench

CELL = "train_s1_res64"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for machines without one")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", CELL,
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_nothing_loaded_is_jax_or_the_jax_package(tmp_path):
    bench = tiny_bench(tmp_path, CELL)
    code = f"""
import sys, torch
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {os.path.dirname(__file__)!r})
from conftest import run_cell
rc = run_cell({bench!r}, {CELL!r}, trace=True)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'fmri_tpu')]
print('RC', rc, 'BAD', bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600).stdout
    assert "RC 0 BAD []" in out, out[-2000:]


def test_the_harness_refuses_a_loaded_jax_package(tmp_path, capsys, monkeypatch):
    bench = tiny_bench(tmp_path, CELL)
    monkeypatch.setitem(sys.modules, "fmri_tpu", type(sys)("fmri_tpu"))
    assert run_cell(bench, CELL) == 3
    assert not capsys.readouterr().out.strip().endswith("}")


def _unchanged(monkeypatch):
    from fmri_tpu_torch.train import optim

    monkeypatch.setattr(optim.RmsProp, "update", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from fmri_tpu_torch.train import steps_vgan

    make = steps_vgan.make_vgan_stage1_step

    def half(*a, **k):
        fns = make(*a, **k)

        def train_step(state, x, eps, z_p, *gate):
            n = x.shape[0] // 2
            return fns.train_step(state, x[:n], eps[:n], z_p[:n], *gate)

        return fns._replace(train_step=train_step)

    monkeypatch.setattr(steps_vgan, "make_vgan_stage1_step", half)
    from fmri_tpu_torch.train import stages

    monkeypatch.setattr(stages, "make_vgan_stage1_step", half)


def _altered_gradient(monkeypatch):
    from fmri_tpu_torch.train import optim

    update = optim.RmsProp.update

    def altered(self, grads, sq_avg, params, lr, gate=1.0):
        grads = dict(grads)
        k = next(iter(grads))
        grads[k] = grads[k] * 1.5
        return update(self, grads, sq_avg, params, lr, gate)

    monkeypatch.setattr(optim.RmsProp, "update", altered)


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch, _altered_gradient])
def test_a_broken_train_step_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    bench = tiny_bench(tmp_path, CELL)
    if fault is not None:
        fault(monkeypatch)
    assert run_cell(bench, CELL) == 0
    assert last_result(capsys.readouterr().out)["correct"] is (fault is None)


def _altered_image(monkeypatch):
    from fmri_tpu_torch.eval import serve

    chunk = serve.ServingModel._reconstruct_chunk

    def altered(self, x):
        out = chunk(self, x).copy()
        out[0, 0, 0] = out[0, 0, 0] ^ 0x40
        return out

    monkeypatch.setattr(serve.ServingModel, "_reconstruct_chunk", altered)


def _half_bucket(monkeypatch):
    from fmri_tpu_torch.eval import serve

    chunk = serve.ServingModel._reconstruct_chunk

    def half(self, x):
        out = chunk(self, x).copy()
        out[len(out) // 2:] = 0
        return out

    monkeypatch.setattr(serve.ServingModel, "_reconstruct_chunk", half)


@pytest.mark.parametrize("fault", [None, _altered_image, _half_bucket])
def test_a_broken_server_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    bench = tiny_bench(tmp_path, "serve_s3_res100")
    with open(os.path.join(bench, "traffic", "serve_open_4800.json")) as f:
        traffic = json.load(f)
    # every request checked, so an altered one is always in the sample
    traffic["sample"] = 10**6
    with open(os.path.join(bench, "traffic", "serve_open_4800.json"), "w") as f:
        json.dump(traffic, f)
    if fault is not None:
        fault(monkeypatch)
    assert run_cell(bench, "serve_s3_res100", seconds=0.5) == 0
    assert last_result(capsys.readouterr().out)["correct"] is (fault is None)


@pytest.mark.parametrize("cell", ["train_s1_res64", "train_s2_res64", "serve_s3_res100"])
def test_the_control_is_not_correct(tmp_path, cell):
    """The reference in the program's place one precision down (float8 for
    the bf16 configurations) fails the cell's limits; the tiny widths'
    bf16 program is held to the same limits as the control's own run."""
    from portbench import control, harness

    bench = tiny_bench(tmp_path, cell, compute_dtype="bfloat16")
    c, config, traffic = harness.load_cell(cell, bench)
    if traffic["kind"] == "open_loop":
        traffic["sample"] = 64
    numbers = control.control_numbers(c, config, traffic, 2**31 + 7, torch.device("cpu"))
    assert not harness.judge(numbers, c["limits"]), numbers


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", CELL,
                        "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = last_result(p.stdout)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


def test_stage2_is_built_by_the_trainers_stage_builder(tmp_path, capsys, monkeypatch):
    """Stage II's state and step come from ``vgan_stage2``, which reads the
    stage-I groups from a thesis-layout ``.pth``."""
    from fmri_tpu_torch.train import stages

    built = []
    real = stages.vgan_stage2

    def spy(cfg, ckpt, **k):
        built.append(os.path.basename(ckpt))
        return real(cfg, ckpt, **k)

    monkeypatch.setattr(stages, "vgan_stage2", spy)
    bench = tiny_bench(tmp_path, "train_s2_res64")
    assert run_cell(bench, "train_s2_res64") == 0
    assert built == ["stage1.pth"]
    assert last_result(capsys.readouterr().out)["correct"] is True


def test_the_gc_clock_times_collections():
    import gc

    from portbench import harness

    clock = harness.GcClock()
    gc.collect()
    clock.stop()
    gc.collect()
    assert clock.n[2] == 1 and clock.seconds() > 0.0
    assert clock not in gc.callbacks
