"""The port's train and inference CLIs on raw data (``tiny``, ``--device
cpu``), made here with PIL, ``np.savez``, ``scipy.io.savemat`` and
``pickle``: one epoch for ``--dataset coco|bold|mnist69``; their train and
valid arrays bitwise the JAX CLI's ``_load_images``/``_load_pairs`` on the
same flags; a second ``--cache-dir`` run that decodes nothing; the inference
CLI's ``--dataset bold`` validation split; the parsers' flags and defaults
against the JAX CLIs'; and cuDNN's deterministic algorithms inside
``Trainer.fit``, ``evaluate_batches`` and the inference CLI."""

import argparse
import csv
import dataclasses
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from fmri_tpu.configs import get_config as jax_get_config
from fmri_tpu.eval import inference as jax_inference
from fmri_tpu.eval import serve as jax_serve
from fmri_tpu.train import run as jax_run
from fmri_tpu_torch.configs.presets import get_config
from fmri_tpu_torch.data import datasets
from fmri_tpu_torch.eval import inference, serve
from fmri_tpu_torch.train import run
from torch_port_helpers import one_torch_thread  # noqa: F401

BS = 4
CPU = ["--preset", "tiny", "--device", "cpu", "--batch-size", str(BS)]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A COCO-style image dir (RGB/grey/RGBA, JPEG/PNG) with a second dir for
    validation, a CSI1/CSI2 ROI dir of 128 voxels (one .npz, one pickle)
    whose stimuli are those images, its records as a pickle, and a .mat of
    24 MNIST69 rows."""
    import scipy.io as sio

    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    for name, n in (("coco", 24), ("coco_valid", 5)):
        d = root / name
        d.mkdir()
        for i in range(n):
            shape = ((30, 26), (30, 26, 3), (24, 31, 4))[i % 3]
            ext = "jpg" if i % 6 == 1 else "png"  # JPEG holds no alpha
            Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
                d / f"{i:012d}.{ext}")
    stims = sorted(glob.glob(str(root / "coco" / "*")))
    for sub, n, fmt in (("CSI1", 14, "npz"), ("CSI2", 10, "pickle")):
        d = root / "bold" / sub
        d.mkdir(parents=True)
        roi = rng.normal(1.0, 2.0, (n, 128))
        if fmt == "npz":
            np.savez(d / f"{sub}_roi_pad.npz", roi=roi)
        else:
            with open(d / f"{sub}_roi_pad.pickle", "wb") as f:
                pickle.dump(roi, f)
        with open(d / f"{sub}_stimuli_paths.pickle", "wb") as f:
            pickle.dump([stims[(3 * i + n) % len(stims)] for i in range(n)], f)
    records = [{"fmri": rng.normal(size=128).astype(np.float32), "image": stims[i % 24]}
               for i in range(22)]
    with open(root / "records.pickle", "wb") as f:
        pickle.dump(records, f)
    rows = np.concatenate([rng.integers(0, 256, (24, 784)).astype(np.float64),
                           rng.normal(size=(24, 128))], axis=1)
    sio.savemat(str(root / "mnist69.mat"), {"D": rows})
    return root


@pytest.fixture(scope="module")
def stage1_ckpt(tmp_path_factory):
    out = tmp_path_factory.mktemp("s1")
    assert run.main([*CPU, "--family", "vgan", "--stage", "1", "--dataset", "synthetic",
                     "--synthetic-n", "24", "--epochs", "1", "-o", str(out)]) == 0
    return glob.glob(str(out / "vgan_stage1" / "*" / "checkpoints"))[0]


def _run_dir(out):
    return sorted(glob.glob(os.path.join(str(out), "*", "*")))[-1]


def _row(run_dir):
    with open(os.path.join(run_dir, "results.csv")) as f:
        row, = csv.DictReader(f)
    return row


def _no_decoding(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an image was decoded though the cache holds it")

    monkeypatch.setattr(datasets, "load_stimulus", refuse)


# ------------------------------------------------------------ loader parity


# "@name" stands for the file or dir ``name`` of the ``raw`` fixture
LOADERS = {
    "coco": ("_load_images", ["--dataset", "coco", "-i", "@coco"]),
    "coco-valid-input": ("_load_images", ["--dataset", "coco", "-i", "@coco",
                                          "--valid-input", "@coco_valid"]),
    "bold-dir": ("_load_pairs", ["--dataset", "bold", "-i", "@bold"]),
    "bold-records": ("_load_pairs", ["--dataset", "bold", "-i", "@records.pickle"]),
    "mnist69": ("_load_pairs", ["--dataset", "mnist69", "-i", "@mnist69.mat"]),
}


def _args(parser, argv, root):
    argv = [str(root / a[1:]) if a.startswith("@") else a for a in argv]
    return parser.parse_args(["--family", "vgan", *argv])


def _configs():
    port, ref = get_config("tiny"), jax_get_config("tiny")
    return (port.replace(train=dataclasses.replace(port.train, batch_size=BS)),
            ref.replace(train=dataclasses.replace(ref.train, batch_size=BS)))


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_loaders_are_the_jax_clis_bitwise(raw, tmp_path, case):
    """The port's train and valid arrays for the same flags equal the JAX
    CLI's, read from the files, then from a cache written by either CLI."""
    loader, argv = LOADERS[case]
    cfg, jax_cfg = _configs()
    ours = getattr(run, loader)(_args(run.build_parser(), argv, raw), cfg)
    theirs = getattr(jax_run, loader)(_args(jax_run.build_parser(), argv, raw), jax_cfg)
    for a, b in zip(ours, theirs):
        a, b = (a, b) if isinstance(a, dict) else ({"image": a}, {"image": b})
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    n = len(ours[0]["image"] if isinstance(ours[0], dict) else ours[0])
    assert n >= BS
    if case.startswith("bold"):
        cache = ["--cache-dir", str(tmp_path / "cache")]
        ours_c = run._load_pairs(_args(run.build_parser(), argv + cache, raw), cfg)
        theirs_c = jax_run._load_pairs(_args(jax_run.build_parser(), argv + cache, raw),
                                       jax_cfg)  # reads the port's cache
        assert sorted(os.listdir(tmp_path / "cache")) == ["bold_train.npz", "bold_valid.npz"]
        for a, b in zip(ours_c, theirs_c):
            for k in a:
                assert a[k].tobytes() == b[k].tobytes(), k


# ------------------------------------------------------------------ the CLIs


def test_coco_stage1_with_a_cache(raw, tmp_path, monkeypatch):
    """One epoch on a COCO dir writing ``--cache-dir``, then a second run
    that reads it and decodes nothing, to the same losses."""
    cache = str(tmp_path / "cache")
    argv = [*CPU, "--family", "vgan", "--stage", "1", "--dataset", "coco",
            "-i", str(raw / "coco"), "--cache-dir", cache, "--epochs", "1"]
    assert run.main([*argv, "-o", str(tmp_path / "a")]) == 0
    assert os.listdir(cache) == ["coco_train.npz"]
    first = _row(_run_dir(tmp_path / "a"))
    _no_decoding(monkeypatch)
    assert run.main([*argv, "-o", str(tmp_path / "b")]) == 0
    second = _row(_run_dir(tmp_path / "b"))
    assert first == second and all(np.isfinite(float(v)) for v in first.values())


def test_bold_stage2_and_inference_with_a_cache(raw, tmp_path, monkeypatch, stage1_ckpt):
    """Stage II on the CSI* dir with ``--cache-dir``; a second run and the
    inference CLI on the 20% test split read the cache alone."""
    cache = str(tmp_path / "cache")
    argv = [*CPU, "--family", "vgan", "--stage", "2", "--dataset", "bold",
            "-i", str(raw / "bold"), "--cache-dir", cache, "--epochs", "1",
            "--prev-ckpt", stage1_ckpt]
    assert run.main([*argv, "-o", str(tmp_path / "a")]) == 0
    first = _row(_run_dir(tmp_path / "a"))
    _no_decoding(monkeypatch)
    assert run.main([*argv, "-o", str(tmp_path / "b")]) == 0
    assert _row(_run_dir(tmp_path / "b")) == first
    out = tmp_path / "inf"
    assert inference.main([*CPU, "--family", "vgan", "--stage", "2", "--dataset", "bold",
                           "-i", str(raw / "bold"), "--cache-dir", cache, "-l", "ignored",
                           "--ckpt", os.path.join(_run_dir(tmp_path / "a"), "checkpoints"),
                           "-o", str(out)]) == 0
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert summary["num_images"] == 5 and 0.0 < summary["ssim"] <= 1.0  # ceil(0.2 * 24)


def test_mnist69_stage2(raw, tmp_path, stage1_ckpt):
    assert run.main([*CPU, "--family", "vgan", "--stage", "2", "--dataset", "mnist69",
                     "-i", str(raw / "mnist69.mat"), "--epochs", "1",
                     "--prev-ckpt", stage1_ckpt, "-o", str(tmp_path)]) == 0
    assert all(np.isfinite(float(v)) for v in _row(_run_dir(tmp_path)).values())


def test_inference_bold_split_is_the_jax_clis(raw):
    """The inference CLI's raw ``--dataset bold`` data is ``split_dataset``'s
    20% test split, as the JAX CLI takes it (through the train CLI's
    loader)."""
    cfg, jax_cfg = _configs()
    argv = ["--stage", "3", "--ckpt", "x", "--dataset", "bold", "-i", str(raw / "bold")]
    ours = inference.load_valid(_args(inference.build_parser(), argv, raw), cfg)
    _, theirs = jax_run._load_pairs(_args(jax_inference.build_parser(), argv, raw), jax_cfg)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].tobytes() == theirs[k].tobytes(), k
    assert len(ours["fmri"]) == 5


@pytest.mark.parametrize("argv,message", [
    (["--dataset", "coco"], "needs --input"),
    (["--dataset", "bold"], "stage 1 expects"),
    (["--stage", "2", "--dataset", "coco", "--prev-ckpt", "x"], "stages 2/3 expect"),
    (["--stage", "2", "--dataset", "mnist69", "--prev-ckpt", "x"], "needs --input"),
])
def test_raw_flags_the_loaders_refuse(tmp_path, argv, message):
    with pytest.raises(SystemExit, match=message):
        run.main([*CPU, "--family", "vgan", "-o", str(tmp_path), *argv])


# ------------------------------------------------------------ parser parity


def _flags(parser):
    return {a.dest: (tuple(sorted(a.option_strings)), a.default, a.choices, a.type,
                     a.required, a.nargs, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


# flags one CLI has and the other does not, by name: the port's --device
ALLOWED = {"device"}


@pytest.mark.parametrize("cli", ["train", "inference", "serve"])
def test_parser_flags_and_defaults_are_the_jax_clis(cli):
    ours, theirs = {"train": (run, jax_run), "inference": (inference, jax_inference),
                    "serve": (serve, jax_serve)}[cli]
    a, b = _flags(ours.build_parser()), _flags(theirs.build_parser())
    differ = {k for k in set(a) | set(b) if a.get(k) != b.get(k)}
    assert differ <= ALLOWED, {k: (a.get(k), b.get(k)) for k in differ - ALLOWED}
    assert "device" in a and "device" not in b
    if cli == "inference":
        assert a["stage"][1] == b["stage"][1] == 1
        assert a["logs"][0] == ("--logs", "-l") and a["no_is"] == b["no_is"]


# -------------------------------------------------------------- determinism


def test_trainer_and_inference_run_with_deterministic_cudnn(tmp_path, monkeypatch):
    """cuDNN's deterministic algorithms are on inside ``Trainer.fit`` and
    ``evaluate_batches`` whatever the caller set, and the caller's setting
    comes back afterwards; the inference CLI reconstructs under them."""
    from fmri_tpu_torch.data.synthetic import synthetic_images
    from fmri_tpu_torch.eval import evaluate
    from fmri_tpu_torch.train.stages import BUILDERS
    from fmri_tpu_torch.train.trainer import Draws, Trainer

    cfg, _ = _configs()
    imgs, _ = synthetic_images(12, 16, seed=0)
    seen = []
    for caller in (False, True):
        torch.backends.cudnn.deterministic = caller
        state, steps, kw = BUILDERS["vgan_stage1"](cfg, steps_per_epoch=2, seed=0,
                                                   device="cpu")
        inner = steps.eval_step
        (tmp_path / str(caller)).mkdir()
        trainer = Trainer(cfg, steps._replace(eval_step=lambda *a: (
            seen.append(("eval", torch.backends.cudnn.deterministic)), inner(*a))[1]),
            str(tmp_path / str(caller)), tensorboard=False, **kw)
        trainer.fit(state, imgs[4:], imgs[:4], n_epochs=1, epoch_callback=lambda *a: (
            seen.append(("fit", torch.backends.cudnn.deterministic))))
        assert torch.backends.cudnn.deterministic is caller
        trainer.evaluate_batches(state, [imgs[:4]], Draws(0).eval(0, 0, torch.device("cpu")))
        assert torch.backends.cudnn.deterministic is caller
    torch.backends.cudnn.deterministic = False
    assert seen and all(flag for _, flag in seen) and {k for k, _ in seen} == {"eval", "fit"}

    real = evaluate.reconstruct_dataset
    flags = []
    monkeypatch.setattr(evaluate, "reconstruct_dataset", lambda *a, **k: (
        flags.append(torch.backends.cudnn.deterministic), real(*a, **k))[1])
    ckpt = str(tmp_path / "False" / "checkpoints")
    assert inference.main([*CPU, "--family", "vgan", "--ckpt", ckpt, "--synthetic-n", "12",
                           "--no-evaluate", "-o", str(tmp_path / "inf")]) == 0
    assert flags == [True] and torch.backends.cudnn.deterministic is False
