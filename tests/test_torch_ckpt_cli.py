"""The port's checkpoint import/export CLI
(``fmri_tpu_torch/checkpoints/torch_import.py``) against the JAX package's
(``fmri_tpu/checkpoints/torch_import.py::main``), in-process at ``tiny``:
for each of the JAX CLI's kinds, the JAX CLI imports a seeded ``.pth`` and
exports its checkpoint; the port imports that export and exports its own
dir, which must equal the JAX export key for key, in order, bitwise, and
convert back to the JAX groups; the imported dir serves and infers bitwise
like the ``.pth``; the parsers' flags and defaults are the JAX CLI's.
"""

import argparse

import numpy as np
import pytest
import torch

from fmri_tpu_torch.checkpoints import convert, torch_import
from fmri_tpu_torch.configs import get_config

KINDS = ["dcgan", "vae-gan", "vae-gan-cognitive", "wae-gan", "wae-gan-cognitive"]


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """{kind: (the seeded JAX groups, the JAX export, the port's dir, the
    port's export)}."""
    from fmri_tpu.checkpoints import torch_import as jax_cli

    root = tmp_path_factory.mktemp("ckpt_cli")
    cfg = get_config("tiny")
    out = {}
    for i, kind in enumerate(KINDS):
        groups = convert.random_groups(cfg, seed=30 + i, kind=kind)
        src, jdir, jpth, pdir, ppth = (str(root / f"{kind}_{n}") for n in (
            "src.pth", "jax", "jax.pth", "port", "port.pth"))
        torch.save(convert.from_jax_groups(groups, cfg, kind), src)
        common = ["--kind", kind, "--preset", "tiny"]
        assert jax_cli.main(["-i", src, "-o", jdir, *common]) == 0
        assert jax_cli.main(["--export", "-i", jdir, "-o", jpth, *common]) == 0
        assert torch_import.main(["-i", jpth, "-o", pdir, "--epoch", "3", *common]) == 0
        assert torch_import.main(["--export", "-i", pdir, "-o", ppth, *common]) == 0
        out[kind] = (groups, jpth, pdir, ppth)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_is_the_jax_export_bitwise(exports, kind):
    _, jpth, pdir, ppth = exports[kind]
    want = torch.load(jpth, weights_only=True)
    got = torch.load(ppth, weights_only=True)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    if kind == "vae-gan-cognitive":  # the teacher and its copies of the shared modules
        assert any(k.startswith("teacher_net.decoder.") for k in got)
    meta = torch_import.store.checkpoint_meta(f"{pdir}/ckpt_00003")
    assert meta["imported_from"] == jpth and meta["kind"] == kind
    assert meta["preset"] == "tiny" and meta["epoch"] == 3


@pytest.mark.parametrize("kind", KINDS)
def test_jax_reads_the_port_export_as_its_groups(exports, kind):
    from fmri_tpu.checkpoints.torch_import import load_reference_checkpoint
    from fmri_tpu.configs import get_config as jax_config

    groups, _, _, ppth = exports[kind]
    back = load_reference_checkpoint(ppth, jax_config("tiny"), kind=kind)
    expected = {g for g in groups if g != "teacher_encoder" or kind == "vae-gan-cognitive"}
    assert set(back) == expected

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        else:
            yield path, np.asarray(tree)

    for g in expected:
        got, want = dict(leaves(back[g])), dict(leaves(groups[g]))
        assert got.keys() == want.keys(), g
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{g}{k}")


@pytest.mark.parametrize("kind, stage", [("vae-gan", 1), ("vae-gan-cognitive", 3)])
def test_imported_dir_serves_and_infers_like_the_pth(exports, kind, stage):
    from fmri_tpu_torch.eval.inference import load_weights
    from fmri_tpu_torch.eval.serve import ServingModel

    _, jpth, pdir, _ = exports[kind]
    a, b = load_weights(pdir)[0], load_weights(jpth)[0]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    served = [ServingModel.from_checkpoint(src, "vgan", stage, "tiny", max_batch=4,
                                           device="cpu") for src in (pdir, jpth)]
    rng = np.random.default_rng(stage)
    x = rng.normal(size=(3, *served[0].sample_shape())).astype(np.float32)
    np.testing.assert_array_equal(served[0].reconstruct(x), served[1].reconstruct(x))


def test_prev_ckpt_takes_the_imported_dir(exports):
    """A stage-II build from the imported stage-I dir, as ``--prev-ckpt``."""
    from fmri_tpu_torch.checkpoints.store import load_groups
    from fmri_tpu_torch.train.state import VaeGan

    _, jpth, pdir, _ = exports["vae-gan"]
    from_dir = load_groups(pdir, ["encoder", "decoder", "discriminator"])
    from_pth = load_groups(jpth, ["encoder", "decoder", "discriminator"],
                           prefixes=VaeGan.PREFIXES)
    for g, sd in from_pth.items():
        assert all(torch.equal(from_dir[g][k], v) for k, v in sd.items()), g


def test_refuses_what_does_not_fit(exports, tmp_path):
    _, jpth, _, _ = exports["vae-gan"]
    sd = torch.load(jpth, weights_only=True)
    stray = str(tmp_path / "stray.pth")
    torch.save({**sd, "extra.weight": torch.zeros(1)}, stray)
    with pytest.raises(SystemExit, match="keys outside the groups"):
        torch_import.main(["-i", stray, "-o", str(tmp_path / "x"), "--preset", "tiny"])
    with pytest.raises(SystemExit, match="shapes differ"):
        torch_import.main(["-i", jpth, "-o", str(tmp_path / "y"), "--preset", "res64"])
    with pytest.raises(SystemExit, match="'encoder' of kind 'vae-gan-cognitive': keys differ"):
        torch_import.main(["-i", jpth, "-o", str(tmp_path / "z"), "--preset", "tiny",
                           "--kind", "vae-gan-cognitive"])
    with pytest.raises(SystemExit, match=r"kind 'vae-gan' needs groups \['encoder'\]"):
        torch_import.main(["-i", exports["dcgan"][1], "-o", str(tmp_path / "w"),
                           "--preset", "tiny"])


def _jax_parser():
    """The parser the JAX CLI builds inside its ``main``."""
    from fmri_tpu.checkpoints import torch_import as jax_cli

    class Caught(Exception):
        pass

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, *a, **k):
        seen["parser"] = self
        raise Caught

    argparse.ArgumentParser.parse_args = catch
    try:
        jax_cli.main([])
    except Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["parser"]


def test_parser_flags_and_defaults_are_the_jax_clis():
    def flags(parser):
        return {tuple(a.option_strings): (a.dest, a.default, a.required, a.choices, a.type)
                for a in parser._actions if a.option_strings != ["-h", "--help"]}

    assert flags(torch_import.build_parser()) == flags(_jax_parser())


def test_port_scripts_name_the_ports_mains():
    """Every ``fmri-tpu-torch-*`` console script but the JAX import CLI's
    (``fmri-tpu-torch-ckpt``) is a ``main`` of the port, one for each JAX
    script."""
    import importlib
    import os
    import tomllib

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "pyproject.toml"),
              "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items()
            if k.startswith("fmri-tpu-torch-") and k != "fmri-tpu-torch-ckpt"}
    jax = {k for k in scripts if not k.startswith("fmri-tpu-torch-") or k == "fmri-tpu-torch-ckpt"}
    assert {"fmri-tpu-torch-" + k[len("fmri-tpu-"):] for k in jax} == set(port)
    for target in port.values():
        module, fn = target.split(":")
        assert module.startswith("fmri_tpu_torch.") and fn == "main"
        assert callable(getattr(importlib.import_module(module), fn)), target
