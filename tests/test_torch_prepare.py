"""The port's prepare CLI and packed writers (``fmri_tpu_torch/data/
prepare.py``, ``data/packed.py``) against the JAX package's, in one
process (one string hash seed) on the same BOLD5000-layout fixture: every
subcommand writes the same files (``.npy`` and ``meta.json`` byte for byte,
``.npz`` array for array since zip entries carry timestamps, pickles equal
once loaded) and prints the same summary line."""

import io
import json
import os
import pickle
from contextlib import redirect_stdout

import numpy as np
import pytest
from torch_port_helpers import write_bold5000

from fmri_tpu.data import packed as jax_packed
from fmri_tpu.data import prepare as jax_prepare
from fmri_tpu_torch.data import packed, prepare


@pytest.fixture(scope="module")
def bold5000(tmp_path_factory):
    return write_bold5000(str(tmp_path_factory.mktemp("bold5000")), seed=1)


def _same(a, b) -> bool:
    """Deep equality of loaded pickles holding numpy arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return type(b) is dict and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_tree(ours, theirs):
    assert _files(ours) == _files(theirs)
    for rel in _files(ours):
        a, b = os.path.join(ours, rel), os.path.join(theirs, rel)
        if rel.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files, rel
                for k in x.files:
                    assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes(), \
                        (rel, k)
        elif rel.endswith(".pickle"):
            with open(a, "rb") as f, open(b, "rb") as g:
                assert _same(pickle.load(f), pickle.load(g)), rel
        else:
            with open(a, "rb") as f, open(b, "rb") as g:
                assert f.read() == g.read(), rel


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def both(bold5000, tmp_path_factory):
    """Every subcommand, in the order a user runs them, by each package
    into its own dir; (dirs, {subcommand: (port line, JAX line)})."""
    root = tmp_path_factory.mktemp("prepare")
    dirs, lines = {}, {}
    coco = os.path.join(bold5000["stimuli"], "COCO")
    lists = os.path.join(bold5000["rois"], "stim_lists")
    for side, main in (("port", prepare.main), ("jax", jax_prepare.main)):
        out = dirs[side] = str(root / side)
        roi = os.path.join(out, "bold_roi")
        steps = {
            "parse-sessions": ["-i", bold5000["ds001499"], "--stimuli", bold5000["stimuli"],
                               "-o", os.path.join(out, "bold5000.pickle")],
            "extract-roi": ["-i", bold5000["rois"], "-o", roi, "--subjects", "CSI1", "CSI2"],
            "stimuli-paths": ["-i", lists, "--bold-index",
                              os.path.join(out, "bold5000.pickle"), "-o", roi],
            "split-stimuli": ["-i", os.path.join(lists, "CSI01_stim_lists.txt"), "-o", roi,
                              "--ratio", "0.25"],
            "pack": ["-i", roi, "-o", os.path.join(out, "packed"), "--subjects", "CSI1",
                     "CSI2", "--crop", "32", "--size", "16"],
            "pack-stream npz": ["-i", os.path.join(out, "packed", "bold_train.npz"), "-o",
                                os.path.join(out, "stream_npz")],
            "pack-stream pickle": ["-i", os.path.join(out, "packed", "bold_train.pickle"),
                                   "-o", os.path.join(out, "stream_pickle"), "--crop", "32",
                                   "--size", "16"],
            "pack-stream dir": ["-i", coco, "-o", os.path.join(out, "stream_dir"),
                                "--crop", "32", "--size", "16"],
        }
        for name, argv in steps.items():
            line = _run(main, [name.split()[0], *argv])
            if name == "parse-sessions":
                line["saved"] = os.path.relpath(line["saved"], out)
            lines.setdefault(name, []).append(line)
    return dirs, lines


def test_every_subcommand_prints_the_jax_line(both):
    _, lines = both
    for name, (ours, theirs) in lines.items():
        assert ours == theirs, name
    assert lines["pack"][0]["train"]["image"][1:] == [16, 16, 3]
    assert lines["pack-stream dir"][0] == {"image": [9, 16, 16, 3]}


def test_every_subcommand_writes_the_jax_files(both):
    _assert_same_tree(both[0]["port"], both[0]["jax"])


def test_pack_stream_inputs_agree(both):
    """The .npz cache and the record pickle it was made from give the same
    packed dir: uint8 images stored as they are, floats quantized with the
    same codec."""
    out = both[0]["port"]
    for name in ("fmri.npy", "image.npy", "meta.json"):
        with open(os.path.join(out, "stream_npz", name), "rb") as f, \
                open(os.path.join(out, "stream_pickle", name), "rb") as g:
            assert f.read() == g.read(), name
    meta = json.load(open(os.path.join(out, "stream_dir", "meta.json")))
    assert meta == {"keys": ["image"], "quantized": ["image"], "num_examples": 9}


def _writer_inputs(seed):
    rng = np.random.default_rng(seed)
    return {"fmri": rng.normal(size=(9, 5)).astype(np.float32),
            "image": rng.uniform(-0.2, 1.2, (9, 4, 4, 3)).astype(np.float32),
            "images": rng.integers(0, 256, (9, 4, 4, 3), dtype=np.uint8),
            "label": np.arange(9, dtype=np.int64)}


@pytest.mark.parametrize("arrays", ["dict", "one array", "uint8 dict", "no quantize"])
def test_save_packed_writes_the_jax_bytes(tmp_path, arrays):
    """Out-of-range floats clip (never wrap), uint8 images are stored as
    they are, an unnamed array is stored as it is."""
    data = _writer_inputs(3)
    kw = {}
    if arrays == "one array":
        data = data["image"]
    elif arrays == "uint8 dict":
        data = {"images": data["images"], "fmri": data["fmri"]}
    elif arrays == "no quantize":
        kw = {"quantize": ()}
    packed.save_packed(str(tmp_path / "port"), data, **kw)
    jax_packed.save_packed(str(tmp_path / "jax"), data, **kw)
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    # each package's reader reads the other's writer's dir
    ours, theirs = packed.open_packed(str(tmp_path / "jax")), jax_packed.open_packed(
        str(tmp_path / "port"))[0]
    theirs = theirs if isinstance(theirs, dict) else {"image": theirs}
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert np.asarray(ours[k]).tobytes() == np.asarray(theirs[k]).tobytes()


def test_pack_images_streaming_writes_the_jax_bytes(tmp_path):
    images = _writer_inputs(4)["image"]
    for side, fn in (("port", packed.pack_images_streaming),
                     ("jax", jax_packed.pack_images_streaming)):
        fn(lambda i: images[i], len(images), images.shape[1:], str(tmp_path / side),
           chunk=4)
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    stored = np.load(tmp_path / "port" / "image.npy")
    np.testing.assert_array_equal(
        stored, (np.clip(images, 0, 1) * 255 + 0.5).astype(np.uint8))


def test_save_packed_refuses_a_length_mismatch(tmp_path):
    with pytest.raises(ValueError, match="length 3 != 4"):
        packed.save_packed(str(tmp_path), {"fmri": np.zeros((4, 2)), "image": np.zeros(
            (3, 2, 2, 3), np.float32)})


def test_parser_is_the_jax_clis():
    """Every subcommand with the JAX CLI's flags and defaults."""
    import argparse

    def subparsers(build):
        p = build()
        action = next(a for a in p._actions if isinstance(a, argparse._SubParsersAction))
        return {name: {a.dest: (tuple(sorted(a.option_strings)), a.default, a.type,
                                a.required, a.nargs)
                       for a in sp._actions if not isinstance(a, argparse._HelpAction)}
                for name, sp in action.choices.items()}

    captured = {}

    def jax_parser():
        real = jax_prepare.argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            captured["p"] = self
            raise SystemExit(0)

        jax_prepare.argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                jax_prepare.main([])
        finally:
            jax_prepare.argparse.ArgumentParser.parse_args = real
        return captured["p"]

    ours, theirs = subparsers(prepare.build_parser), subparsers(jax_parser)
    assert ours == theirs
    assert list(ours) == ["parse-sessions", "extract-roi", "stimuli-paths",
                          "split-stimuli", "pack", "pack-stream"]


def test_the_cli_runs_without_jax_or_a_kernel_wrapper(tmp_path):
    """A fresh interpreter runs a subcommand with neither JAX nor the JAX
    package nor any kernel wrapper imported: it is host code."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; from fmri_tpu_torch.data import prepare; "
            f"prepare.main(['pack-stream', '-i', {str(tmp_path / 'arrays.npz')!r}, '-o', "
            f"{str(tmp_path / 'out')!r}]); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'fmri_tpu') "
            "or m.startswith('fmri_tpu_torch.ops')); assert not bad, bad")
    np.savez(tmp_path / "arrays.npz", images=np.zeros((3, 4, 4, 3), np.uint8),
             fmri=np.ones((3, 2), np.float32))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout) == {"image": [3, 4, 4, 3], "fmri": [3, 2]}
    assert packed.open_packed(str(tmp_path / "out"))["image"].dtype == np.uint8
