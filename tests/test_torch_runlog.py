"""The port's run artifacts (``fmri_tpu_torch/utils/runlog.py``) and trace
summary (``utils/profile_report.py``) against the JAX package's, on the CPU:
the same CSV text, the same image grids, and PNGs that PIL decodes to the
JAX grid's pixels."""

import builtins
import json
import os

import numpy as np
import pytest
from PIL import Image

from fmri_tpu.utils import runlog as jax_runlog
from fmri_tpu_torch.utils import profile_report, runlog

ROWS = [
    {"epoch": 0, "loss_encoder": 1.25, "valid_PCC": 0.125},
    {"epoch": 1, "loss_encoder": 1.0, "valid_PCC": 0.25},
    {"epoch": 2, "loss_encoder": 0.75, "valid_PCC": float("nan"), "train_SSIM": 0.5},
    {"epoch": 3, "loss_encoder": 0.5, "valid_PCC": 0.375, "train_SSIM": 0.625},
]


def test_results_csv_matches_jax(tmp_path):
    """Row by row, a new column rewriting the file with the union, and a
    reopened file read back and appended to: the same text as JAX's."""
    paths = {name: str(tmp_path / f"{name}.csv") for name in ("port", "jax")}
    for name, mod in (("port", runlog), ("jax", jax_runlog)):
        table = mod.ResultsCSV(paths[name])
        for row in ROWS[:3]:
            table.append(row)
        table = mod.ResultsCSV(paths[name])  # a resumed run
        assert table.last_epoch == 2
        table.append(ROWS[3])
    with open(paths["port"]) as f, open(paths["jax"]) as g:
        assert f.read() == g.read()
    port = runlog.ResultsCSV(paths["port"])
    assert port.column("loss_encoder") == [1.25, 1.0, 0.75, 0.5]
    assert np.isnan(port.column("train_SSIM")[0])


@pytest.mark.parametrize("n,nrow", [(16, 8), (5, 8), (7, 3), (1, 4)])
def test_make_grid_matches_jax(n, nrow):
    images = np.random.default_rng(n).uniform(-0.2, 1.2, (n, 6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(runlog.make_grid(images, nrow=nrow),
                                  jax_runlog.make_grid(images, nrow=nrow))


@pytest.mark.parametrize("n", [16, 3])
def test_png_decodes_to_the_jax_pixels(tmp_path, n):
    """The stdlib encoder's PNG, decoded by PIL, holds the pixels of the JAX
    grid that PIL wrote."""
    images = np.random.default_rng(0).uniform(size=(n, 16, 16, 3)).astype(np.float32)
    runlog.save_image_grid(images, str(tmp_path / "a" / "port.png"))
    jax_runlog.save_image_grid(images, str(tmp_path / "jax.png"))
    with Image.open(tmp_path / "a" / "port.png") as got, Image.open(tmp_path / "jax.png") as want:
        assert got.mode == want.mode == "RGB" and got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_run_dir_layout_matches_jax(tmp_path):
    for debug in (False, True):
        got = runlog.create_run_dir(str(tmp_path), "vgan_stage1", debug=debug,
                                    timestamp="20260101-000000")
        want = jax_runlog.create_run_dir(str(tmp_path / "j"), "vgan_stage1", debug=debug,
                                         timestamp="20260101-000000")
        assert os.path.relpath(got, tmp_path) == os.path.relpath(want, tmp_path / "j")
        assert os.path.isdir(got)


def _without(monkeypatch, *names):
    real = builtins.__import__

    def fake(name, *args, **kwargs):
        if name.split(".")[0] in names:
            raise ImportError(f"no {name}")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", fake)


def test_loss_plots_and_tensorboard_skip_without_their_packages(tmp_path, monkeypatch, caplog):
    table = runlog.ResultsCSV(str(tmp_path / "results.csv"))
    table.append(ROWS[0])
    _without(monkeypatch, "matplotlib", "torch.utils.tensorboard")
    logger = runlog.setup_logging(str(tmp_path))
    with caplog.at_level("INFO"):
        runlog.save_loss_plots(table, str(tmp_path), logger)
    assert "matplotlib is not installed" in caplog.text
    assert not os.path.exists(tmp_path / "plots")
    monkeypatch.setattr(builtins, "__import__", builtins.__import__)
    _without(monkeypatch, "torch")
    tb = runlog.TensorBoard(str(tmp_path))
    tb.scalar("x", 1.0, 0)
    tb.image_grid("g", np.zeros((2, 4, 4, 3)), 0)
    tb.close()
    assert not os.path.exists(tmp_path / "tb")


def test_loss_plots_with_matplotlib(tmp_path):
    table = runlog.ResultsCSV(str(tmp_path / "results.csv"))
    for row in ROWS:
        table.append({**row, "loss_decoder": 1.0, "loss_discriminator": 2.0,
                      "loss_reconstruction": 3.0})
    runlog.save_loss_plots(table, str(tmp_path))
    assert sorted(os.listdir(tmp_path / "plots")) == ["ER_loss.png", "GD_loss.png"]


def _trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_profile_report_counts_busy_time_as_a_union(tmp_path):
    """Two streams' kernels overlapping count once; the window spans every
    timed event, host ones included."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 30},  # overlaps k1
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 70, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 90, "dur": 10},
        {"ph": "M", "name": "process_name", "ts": 0},
    ]
    s = profile_report.summarize(_trace(tmp_path / "t.json", events))
    assert s["window_ms"] == pytest.approx(0.1)
    assert s["busy_ms"] == pytest.approx(0.05)  # [10, 50) and [70, 80)
    assert s["idle_share"] == pytest.approx(0.5)
    assert s["kernels"] == 3
    assert s["by_kernel"] == {"k1": (2, pytest.approx(0.04)), "k2": (1, pytest.approx(0.03))}
    assert "idle 50.0%" in profile_report.format_report(s)
    assert profile_report.main([str(tmp_path)]) == 0


def test_profile_report_by_program_span(tmp_path):
    """Per ``fmri.`` span: calls, host ms, the kernels launched inside it
    (autograd's launch, on a thread with no span, under the step thread's
    spans), their device ms, blocking calls on the span's own thread, and
    the idle gaps whose midpoint it covers; a parent includes its child."""
    def ev(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "fmri.train.step", 0, 1000),
        ev("user_annotation", "fmri.train.backward", 100, 400),
        ev("user_annotation", "fmri.train.optimizer", 600, 300),
        ev("user_annotation", "fmri.input.stage", 150, 100, tid=3),
        ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
        ev("kernel", "dgrad", 120, 80, tid=9, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 300, 5, tid=2, corr=2),  # autograd's thread
        ev("kernel", "wgrad", 400, 100, tid=9, corr=2),
        ev("cuda_runtime", "cudaStreamSynchronize", 700, 50, corr=3),
        ev("cuda_runtime", "cudaStreamSynchronize", 160, 20, tid=3, corr=4),
        ev("cuda_runtime", "cudaLaunchKernel", 800, 5, corr=5),
        ev("kernel", "mul", 850, 10, tid=9, corr=5),
        ev("cuda_runtime", "cudaDeviceSynchronize", 1100, 10, corr=6),  # outside every span
    ]
    s = profile_report.summarize(_trace(tmp_path / "t.json", events))
    rows = {k: {c: pytest.approx(v) for c, v in r.items()} for k, r in s["by_span"].items()}
    # device busy [120, 200), [400, 500), [850, 860): gaps at 300 (200 us) and 675 (350 us)
    assert rows == {
        "fmri.train.step": dict(calls=1, host_ms=1.0, kernels=3, device_ms=0.19, syncs=1,
                                idle_ms=0.55),
        "fmri.train.backward": dict(calls=1, host_ms=0.4, kernels=2, device_ms=0.18, syncs=0,
                                    idle_ms=0.2),
        "fmri.train.optimizer": dict(calls=1, host_ms=0.3, kernels=1, device_ms=0.01, syncs=1,
                                     idle_ms=0.35),
        "fmri.input.stage": dict(calls=1, host_ms=0.1, kernels=0, device_ms=0.0, syncs=1,
                                 idle_ms=0.0),
    }
    report = profile_report.format_report(s)
    assert "-- by program span" in report and "fmri.train.backward" in report


def test_profile_report_of_a_cpu_trace(tmp_path):
    path = _trace(tmp_path / "t.json", [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 10}])
    s = profile_report.summarize(path)
    assert s["idle_share"] is None and s["kernels"] == 0
    assert "no device kernels" in profile_report.format_report(s)
    assert s["by_span"] == {} and "by program span" not in profile_report.format_report(s)
    with pytest.raises(FileNotFoundError):
        profile_report.find_trace(str(tmp_path / "empty"))
