"""``python -m fmri_tpu_torch.train.run`` on the CPU (``tiny``, synthetic data):
the vgan and WAE chains through the port's own checkpoint dirs, WAE/Dual-GAN,
resume, ``--evaluate``, retention, a packed input, the refusals, and the
inference CLI reading a training run's checkpoint dir. The raw datasets are
in ``test_torch_cli_raw.py``."""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

from fmri_tpu.data.packed import save_packed
from fmri_tpu_torch.checkpoints import store
from fmri_tpu_torch.eval import inference
from fmri_tpu_torch.train import run
from torch_port_helpers import one_torch_thread  # noqa: F401

BASE = ["--preset", "tiny", "--dataset", "synthetic", "--device", "cpu", "--epochs", "1"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _train(out, *args):
    assert run.main([*BASE, "-o", str(out), *args]) == 0
    return sorted(glob.glob(os.path.join(str(out), "*", "*")))[-1]  # the newest run dir


def _rows(run_dir):
    with open(os.path.join(run_dir, "results.csv")) as f:
        return list(csv.DictReader(f))


def _ckpts(run_dir):
    return os.path.join(run_dir, "checkpoints")


def test_vgan_chain_and_inference_from_the_run(tmp_path):
    s1 = _train(tmp_path / "s1", "--family", "vgan", "--stage", "1", "--epochs", "2")
    assert [r["epoch"] for r in _rows(s1)] == ["0.0", "1.0"]
    assert sorted(store.list_checkpoints(_ckpts(s1))) == [0, 1]
    s2 = _train(tmp_path / "s2", "--family", "vgan", "--stage", "2", "--prev-ckpt", _ckpts(s1))
    s3 = _train(tmp_path / "s3", "--family", "vgan", "--stage", "3", "--prev-ckpt", _ckpts(s2),
                "--load-epoch", "0")
    for run_dir in (s2, s3):
        row = _rows(run_dir)[0]
        assert all(np.isfinite(float(v)) for v in row.values())
        assert "valid_PCC" in row and "train_SSIM" in row
    # stage III starts from stage II's last state: its frozen encoder keeps
    # stage II's weights (its BatchNorm statistics tick in train mode)
    s2_groups, _ = store.load_eval_state(_ckpts(s2))
    s3_groups, _ = store.load_eval_state(_ckpts(s3))
    for k, v in s2_groups["encoder"].items():
        ticks = "running" in k or k.endswith("num_batches_tracked")
        assert torch.equal(v, s3_groups["encoder"][k]) != ticks, k
    out = tmp_path / "inf"
    assert inference.main(["--family", "vgan", "--stage", "3", "--preset", "tiny",
                           "--dataset", "synthetic", "--device", "cpu", "--ckpt", _ckpts(s3),
                           "-o", str(out)]) == 0
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert summary["checkpoint_epoch"] == 0 and summary["num_images"] == 8
    assert 0.0 < summary["ssim"] <= 1.0 and len(summary["objective"]["top"]) == 3


def test_wae_chain_and_wae_vgan(tmp_path):
    w1 = _train(tmp_path / "w1", "--family", "wae", "--stage", "1")
    w2 = _train(tmp_path / "w2", "--family", "wae", "--stage", "2", "--prev-ckpt", _ckpts(w1))
    w3 = _train(tmp_path / "w3", "--family", "wae", "--stage", "3", "--prev-ckpt", _ckpts(w2),
                "--stage1-ckpt", _ckpts(w1))
    dual = _train(tmp_path / "dual", "--family", "wae-vgan", "--lam", "0.5")
    for run_dir in (w1, w2, w3, dual):
        assert all(np.isfinite(float(v)) for v in _rows(run_dir)[0].values()), run_dir
    assert "loss_penalty" in _rows(w3)[0] and "loss_encoder" in _rows(dual)[0]
    # WAE stage III: the teacher from stage I, the encoder and decoder from stage II
    g1, g2, g3 = (store.load_eval_state(_ckpts(d))[0] for d in (w1, w2, w3))
    for source, group in ((g1, "teacher_encoder"), (g2, "encoder")):
        for k, v in source["encoder"].items():
            if "running" not in k and not k.endswith("num_batches_tracked"):
                assert torch.equal(g3[group][k], v), (group, k)
    with open(os.path.join(dual, "config.json")) as f:
        assert json.load(f)["train"]["wae_vgan_lam"] == 0.5
    out = tmp_path / "inf"
    assert inference.main(["--family", "wae", "--stage", "3", "--preset", "tiny", "--dataset",
                           "synthetic", "--device", "cpu", "--ckpt", _ckpts(w3),
                           "-o", str(out)]) == 0


def test_resume_evaluate_and_keep_last(tmp_path, capsys):
    args = ["--family", "vgan", "--stage", "1", "--keep-last", "1", "--async-ckpt"]
    first = _train(tmp_path, *args, "--epochs", "3")
    assert sorted(store.list_checkpoints(_ckpts(first))) == [2]
    resumed = _train(tmp_path, *args, "--epochs", "5", "--resume-dir", first)
    assert resumed == first
    assert [r["epoch"] for r in _rows(first)] == [f"{e}.0" for e in range(5)]
    assert sorted(store.list_checkpoints(_ckpts(first))) == [4]
    with open(os.path.join(first, "config.json")) as f:
        assert json.load(f)["run"]["start_epoch"] == 3
    capsys.readouterr()
    assert run.main([*BASE, "--family", "vgan", "--stage", "1", "--evaluate",
                     "--resume-dir", first]) == 0
    metrics = json.loads(capsys.readouterr().out)
    assert sorted(metrics) == ["valid_MSE", "valid_PCC", "valid_SSIM"]


def test_on_device_epochs_and_profile(tmp_path, capsys):
    """``--debug`` routes the run under ``debug/`` and writes no checkpoint;
    ``--profile`` traces the second epoch for ``profile_report``."""
    _train(tmp_path, "--family", "vgan", "--stage", "1", "--epochs", "2",
           "--on-device-epochs", "--profile", "--debug")
    run_dir, = glob.glob(str(tmp_path / "debug" / "vgan_stage1" / "*"))
    assert len(_rows(run_dir)) == 2 and not os.path.exists(_ckpts(run_dir))
    from fmri_tpu_torch.utils import profile_report

    assert profile_report.main([os.path.join(run_dir, "profile")]) == 0
    out = capsys.readouterr().out
    assert "no device kernels" in out
    table = out[out.index("-- by program span"):]
    assert "fmri.train.step" in table and "fmri.train.optimizer.encoder" in table


def test_profile_traces_the_input_producer(tmp_path, capsys):
    """``--profile`` records every thread: the table has the producer
    thread's ``input.stage`` beside the step's phases."""
    _train(tmp_path, "--family", "vgan", "--stage", "1", "--epochs", "2", "--profile",
           "--debug")
    run_dir, = glob.glob(str(tmp_path / "debug" / "vgan_stage1" / "*"))
    from fmri_tpu_torch.utils import profile_report

    s = profile_report.summarize(profile_report.find_trace(os.path.join(run_dir, "profile")))
    assert {"fmri.input.stage", "fmri.input.augment", "fmri.train.step", "fmri.train.gate"} <= set(
        s["by_span"])
    assert s["by_span"]["fmri.input.stage"]["calls"] == s["by_span"]["fmri.train.step"]["calls"]


def test_packed_input(tmp_path):
    """A packed dir with uint8 images: stage I on its images, stage II on
    its pairs, a tenth held out for validation."""
    rng = np.random.default_rng(0)
    packed = str(tmp_path / "packed")
    save_packed(packed, {"image": rng.uniform(size=(40, 16, 16, 3)).astype(np.float32),
                         "fmri": rng.normal(size=(40, 128)).astype(np.float32)})
    s1 = _train(tmp_path / "o", "--family", "vgan", "--stage", "1", "--input", packed)
    _train(tmp_path / "o2", "--family", "vgan", "--stage", "2", "--input", packed,
           "--prev-ckpt", _ckpts(s1))
    with pytest.raises(SystemExit, match="smaller than one batch"):
        run.main([*BASE, "--family", "vgan", "--input", packed, "--batch-size", "39"])


@pytest.mark.parametrize("args,error,message", [
    (["--family", "vgan", "--mesh", "data=3"], ValueError,
     r"batch_size=8 is not divisible by the mesh data axis \(3 devices\)"),
    (["--family", "exp", "--exp", "vae", "--mesh", "data=two"], SystemExit,
     "expected 'data=N"),
    (["--family", "vgan", "--mesh", "data=2,model"], SystemExit, "expected 'data=N"),
    (["--family", "vgan", "--mesh", "rows=2"], SystemExit, "expected 'data=N")])
def test_mesh_errors(tmp_path, args, error, message):
    """The mesh's own errors, raised before any rank starts: a batch that
    does not split over the data axis, an unparseable ``--mesh``."""
    with pytest.raises(error, match=message):
        run.main([*BASE, "-o", str(tmp_path), *args])
    assert not os.listdir(tmp_path)


def test_stage_arguments_are_checked(tmp_path):
    with pytest.raises(SystemExit, match="--prev-ckpt"):
        run.main([*BASE, "-o", str(tmp_path), "--family", "vgan", "--stage", "2"])
    with pytest.raises(SystemExit, match="--stage1-ckpt"):
        run.main([*BASE, "-o", str(tmp_path), "--family", "wae", "--stage", "3",
                  "--prev-ckpt", str(tmp_path)])
    with pytest.raises(SystemExit, match="only stage 1"):
        run.main([*BASE, "-o", str(tmp_path), "--family", "wae-vgan", "--stage", "2"])


def test_the_default_device_is_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the CLI asks for CUDA and, without a card,
    raises rather than training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run.main(["--family", "vgan", "--preset", "tiny", "-o", str(tmp_path)])
    assert not os.listdir(tmp_path)
