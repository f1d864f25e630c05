"""The port's evaluation CLIs against the JAX package's on the CPU: the
Inception Score in ``quality_metrics`` and the inference CLI (``--no-is``),
the parity CLI (``fmri_tpu_torch/eval/parity.py``) and the user-study
scorer (``eval/user_study.py``).

The weights are seeded numpy groups at ``tiny``, handed to both packages as
a reference-layout ``.pth`` and as a checkpoint dir of each package's own.
Tolerances are the inference tests': PCC / SSIM / MSE 1e-5, n-way fractions
within 1/N, the proxy IS 1e-5 relative."""

import argparse
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from torch_port_helpers import jax_state, one_torch_thread, port_model  # noqa: F401

from fmri_tpu.checkpoints import torch_import
from fmri_tpu.checkpoints.torch_import import export_state_dict
from fmri_tpu.configs import get_config as jax_config
from fmri_tpu.eval import evaluate as jax_eval
from fmri_tpu.eval import inference as jax_inference
from fmri_tpu.eval import parity as jax_parity
from fmri_tpu.eval import user_study as jax_user_study
from fmri_tpu.metrics import inception as jax_inception
from fmri_tpu.train.steps_vgan import make_vgan_cognitive_step
from fmri_tpu_torch.checkpoints.convert import from_jax_groups, random_groups
from fmri_tpu_torch.checkpoints.store import save_checkpoint
from fmri_tpu_torch.configs import get_config
from fmri_tpu_torch.data.synthetic import synthetic_pairs
from fmri_tpu_torch.eval import evaluate, inference, parity, user_study
from fmri_tpu_torch.metrics import inception
from fmri_tpu_torch.train.state import VaeGanCognitiveTrain, make_cognitive_state

N_SYNTH, BS = 320, 8
N = max(N_SYNTH // 10, BS)  # the synthetic validation split both CLIs take
COMMON = ["--family", "vgan", "--stage", "3", "--preset", "tiny", "--dataset", "synthetic",
          "--synthetic-n", str(N_SYNTH), "--batch-size", str(BS)]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(groups, the .pth, a JAX checkpoint dir, a port checkpoint dir), all
    holding one set of seeded stage-III weights."""
    cfg = get_config("tiny")
    groups = random_groups(cfg, seed=4, kind="vae-gan-cognitive")
    root = tmp_path_factory.mktemp("parity")
    pth = str(root / "reference_stage3.pth")
    sd = export_state_dict({k: groups[k] for k in ("encoder", "decoder", "discriminator")},
                           jax_config("tiny"), kind="vae-gan-cognitive")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, pth)
    jax_dir = str(root / "jax_ckpt")
    assert torch_import.main(["-i", pth, "-o", jax_dir, "--kind", "vae-gan-cognitive",
                              "--preset", "tiny", "--epoch", "3"]) == 0
    nets = VaeGanCognitiveTrain(cfg)
    nets.load_state_dict(from_jax_groups(groups, cfg, "vae-gan-cognitive"), strict=True)
    port_dir = str(root / "port_ckpt")
    save_checkpoint(port_dir, 3, make_cognitive_state(nets, cfg, 3))
    return groups, pth, jax_dir, port_dir


def _quiet(main, argv):
    with redirect_stdout(io.StringIO()):
        assert main(argv) == 0


def _read(path):
    with open(path) as f:
        return json.load(f)


def _assert_metrics_close(got, want, keys=("pcc", "ssim", "mse")):
    for k in keys:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    for k in ("is_mean", "is_std"):
        if k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-12), k
    if "is_proxy" in want:
        assert got["is_proxy"] == want["is_proxy"] == 1.0


def test_quality_metrics_scores_the_unit_range_recons_as_jax_does():
    """``with_is`` adds the JAX keys; the classifier sees the denormalized
    [0, 1] reconstructions (``fmri_tpu/eval/evaluate.py:81``), which
    its probabilities pin: the [-1, 1] images give other ones."""
    cfg = get_config("tiny")
    groups = random_groups(cfg, seed=5)
    data = synthetic_pairs(N, cfg.data.image_size, cfg.model.num_voxels, seed=2)
    batches = [{k: v[lo:lo + BS] for k, v in data.items()} for lo in range(0, N, BS)]
    recons, targets = evaluate.reconstruct_dataset(port_model(groups, cfg), batches)
    step = make_vgan_cognitive_step(jax_config("tiny"), 3, donate=False).eval_step
    ref_r, ref_t = jax_eval.reconstruct_dataset(step, jax_state(groups), iter(batches))
    np.testing.assert_allclose(recons.numpy(), ref_r, atol=1e-5)

    got = evaluate.quality_metrics(recons, targets)
    want = jax_eval.quality_metrics(ref_r, ref_t, with_is=True)
    assert list(got) == list(want) == ["pcc", "ssim", "mse", "is_mean", "is_std", "is_proxy"]
    _assert_metrics_close(got, want)
    assert list(evaluate.quality_metrics(recons, targets, with_is=False)) == ["pcc", "ssim",
                                                                              "mse"]
    probs = inception.classify(recons)
    np.testing.assert_allclose(probs, jax_inception.classify(ref_r), rtol=0, atol=1e-6)
    assert np.abs(inception.classify(2.0 * recons - 1.0) - probs).max() > 1e-5


def test_parser_is_the_jax_parity_clis():
    def flags(p):
        return {a.dest: (tuple(sorted(a.option_strings)), a.default, a.choices, a.type,
                         a.required, a.nargs, type(a).__name__)
                for a in p._actions if not isinstance(a, argparse._HelpAction)}

    ours, theirs = flags(parity.build_parser()), flags(jax_parity.build_parser())
    assert {k for k in set(ours) | set(theirs) if ours.get(k) != theirs.get(k)} == {"device"}
    assert ours["preset"][1] == "res100" and ours["stage"][1] == 3


@pytest.fixture(scope="module")
def parity_runs(weights, tmp_path_factory):
    """Each package's parity CLI on the .pth and its own checkpoint dir,
    the Inception Score on; returns their output dirs."""
    _, pth, jax_dir, port_dir = weights
    root = tmp_path_factory.mktemp("parity_runs")
    argv = COMMON + ["--ref-ckpt", pth, "--ref-epoch", "3"]
    _quiet(jax_parity.main, argv + ["--ckpt", jax_dir, "-o", str(root / "jax")])
    _quiet(parity.main, argv + ["--ckpt", port_dir, "-o", str(root / "port"),
                                "--device", "cpu"])
    return str(root / "port"), str(root / "jax")


def test_parity_cli_writes_the_jax_report(parity_runs, weights):
    ours, theirs = (_read(os.path.join(d, "parity.json")) for d in parity_runs)
    assert list(ours) == list(theirs) == ["preset", "family", "stage", "dataset", "rows"]
    assert {k: ours[k] for k in ours if k != "rows"} == {k: theirs[k] for k in theirs
                                                         if k != "rows"}
    assert len(ours["rows"]) == len(theirs["rows"]) == 2
    for got, want in zip(ours["rows"], theirs["rows"]):
        assert list(got) == list(want)
        assert got["num_images"] == want["num_images"] == N
        _assert_metrics_close(got, want)
        for k in [k for k in want if k.endswith("way")]:
            assert abs(got[k] - want[k]) <= 1.0 / N + 1e-12, k
    assert ours["rows"][0]["checkpoint"] == theirs["rows"][0]["checkpoint"] \
        == "reference (reference_stage3.pth)"
    assert ours["rows"][1]["checkpoint"] == f"framework ({weights[3]})"
    # the .pth and the checkpoint dir hold the same weights: one result
    a, b = ours["rows"]
    assert {k: v for k, v in a.items() if k != "checkpoint"} == \
        {k: v for k, v in b.items() if k != "checkpoint"}
    md = [open(os.path.join(d, "parity.md")).read().splitlines() for d in parity_runs]
    assert md[0][:2] == md[1][:2] and len(md[0]) == len(md[1]) == 4
    assert md[0][0].split(" | ")[-1] == "ssim_10way |"
    # the .pth passes straight through; --ref-epoch labels its summary
    assert not os.path.exists(os.path.join(parity_runs[0], "converted_ref_ckpt"))
    for d in parity_runs:
        assert _read(os.path.join(d, "ref", "summary.json"))["checkpoint_epoch"] == 3


def test_inference_cli_is_keys_match_jax(parity_runs, weights, tmp_path):
    """With the IS on (the parity runs' rows are the inference CLI's
    summaries) and with ``--no-is``: the JAX summary's keys, the
    ``is_*`` values; the port adds only where the weights came from and its
    device."""
    _, pth, jax_dir, port_dir = weights
    summaries = {}
    for is_on in (True, False):
        if is_on:
            ours, theirs = (_read(os.path.join(d, "framework", "summary.json"))
                            for d in parity_runs)
        else:
            _quiet(jax_inference.main, COMMON + ["--ckpt", jax_dir, "--no-is", "-o",
                                                 str(tmp_path / "jax")])
            _quiet(inference.main, COMMON + ["--ckpt", port_dir, "--no-is", "-o",
                                             str(tmp_path / "port"), "--device", "cpu"])
            ours, theirs = (_read(tmp_path / d / "summary.json") for d in ("port", "jax"))
        assert set(ours) - set(theirs) == {"checkpoint", "device"}
        assert set(theirs) <= set(ours)
        assert ours["checkpoint_epoch"] == theirs["checkpoint_epoch"] == 3
        assert any(k.startswith("is_") for k in ours) is is_on
        _assert_metrics_close(ours, theirs)
        summaries[is_on] = ours
    for k in ("pcc", "ssim", "mse", "objective"):
        assert summaries[True][k] == summaries[False][k], k


def _survey(path, rng, rows=26, cols=84):
    fields = ["Timestamp", "Name"] + [f"Q{i}" for i in range(2, cols)]
    lines = [",".join(fields)]
    for r in range(rows):
        answers = [f"Option {int(a)}" for a in rng.integers(1, 4, cols - 2)]
        answers[r % (cols - 2)] = ""  # an unanswered question
        lines.append(",".join([f"2021-09-{r + 1:02d}", f"p{r}"] + answers))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_user_study_scores_as_jax(tmp_path, capsys):
    csv_path = _survey(tmp_path / "results.csv", np.random.default_rng(6))
    got, want = user_study.score_all(csv_path), jax_user_study.score_all(csv_path)
    assert got == want and list(got) == ["task1", "task2", "task4", "task5"]
    assert user_study.REFERENCE_TASKS == jax_user_study.REFERENCE_TASKS
    assert user_study.TASK3_PREFERENCE == jax_user_study.TASK3_PREFERENCE
    assert user_study.main([csv_path, "-o", str(tmp_path / "out")]) == 0
    assert json.loads(capsys.readouterr().out) == want
    assert _read(tmp_path / "out" / "scores.json") == want
    assert os.path.getsize(tmp_path / "out" / "task3_preference.png") > 0
    with pytest.raises(ValueError, match="answer key has 3"):
        user_study.score_task(["a", "b"], [{"a": "Option 1", "b": "Option 2"}], (0, 2),
                              [1, 2, 1])


def test_user_study_without_matplotlib(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    csv_path = _survey(tmp_path / "results.csv", np.random.default_rng(7))
    assert user_study.main([csv_path, "-o", str(tmp_path / "out")]) == 0
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "out")) == ["scores.json"]
