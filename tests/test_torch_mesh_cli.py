"""The train CLI's ``--mesh`` on the CPU (gloo, the CLI starting its own
ranks), at ``tiny``: ``--device cpu --mesh data=2`` for one epoch of stage
I against the same run without ``--mesh``; the mesh run's checkpoint loads
in the inference CLI and resumes in a single-process run.

The mesh run is a subprocess (with its own ``communicate(timeout=...)``),
started together with the single-process run in this process. Most of
either's time is importing TensorBoard, which rank 0 writes.
The runs start from zero RMSprop moments, as the CLI does, so an update is
about ``3.16 lr sign(g)`` and a gradient at rounding level could take
either sign: the two runs' parameters are held per tensor within
``PARAM_TOL`` of how far the single-process run moved them (1e-3 in L2;
the worst measured on the CPU is 5.2e-5), the BatchNorm statistics and the
metrics within ``STATS_TOL`` relative.
"""

import csv
import glob
import os
import subprocess
import sys

import pytest
import torch

from fmri_tpu_torch.checkpoints import store
from fmri_tpu_torch.eval import inference
from fmri_tpu_torch.train import run
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--preset", "tiny", "--dataset", "synthetic", "--device", "cpu", "--epochs", "1",
        "--family", "vgan"]
PARAM_TOL, STATS_TOL = 1e-3, 1e-4

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cli(argv):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "fmri_tpu_torch.train.run", *argv],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(proc, timeout=120):
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    return out


def _run_dir(root, name):
    dirs = glob.glob(os.path.join(root, name, f"{name}_*"))
    assert len(dirs) == 1, dirs
    return dirs[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Stage I with and without ``--mesh data=2``: {kind: run dir}."""
    root = tmp_path_factory.mktemp("cli")
    argv = {kind: [*BASE, "--stage", "1", "-o", str(root / kind)]
            for kind in ("mesh", "single")}
    proc = _cli(argv["mesh"] + ["--mesh", "data=2"])
    try:
        run.main(argv["single"])
    finally:
        log = _wait(proc)
    assert log.count("run artifacts:") == 1, log  # rank 0 alone
    return {kind: _run_dir(str(root / kind), "vgan_stage1") for kind in argv}


def _state(run_dir):
    return torch.load(os.path.join(run_dir, "checkpoints", "ckpt_00000", "state.pt"),
                      weights_only=True)


def _rows(run_dir):
    with open(os.path.join(run_dir, "results.csv")) as f:
        return list(csv.DictReader(f))


def _start():
    """The state both runs started from, as a host tree."""
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.train.stages import BUILDERS

    cfg = get_config("tiny")
    return store.host_tree(BUILDERS["vgan_stage1"](cfg, steps_per_epoch=7, seed=cfg.train.seed,
                                                   device="cpu")[0])


def test_mesh_run_matches_the_single_process_run(runs):
    """The same checkpoint (keys, shapes) within the tolerances, the same
    ``results.csv`` columns and its one row, the log written by rank 0
    alone."""
    mesh, single, start = _state(runs["mesh"]), _state(runs["single"]), _start()
    assert mesh.keys() == single.keys() and int(mesh["step"]) == int(single["step"]) == 7
    for g, sd in single["groups"].items():
        assert mesh["groups"][g].keys() == sd.keys(), g
        for k, v in sd.items():
            got = mesh["groups"][g][k]
            assert got.shape == v.shape, (g, k)
            if k.endswith("num_batches_tracked"):
                assert torch.equal(got, v), (g, k)
            elif "running" in k:
                assert float((got - v).norm() / v.norm()) <= STATS_TOL, (g, k)
            else:
                moved = float((v - start["groups"][g][k]).norm())
                gap = float((got - v).norm())
                assert gap <= PARAM_TOL * moved or gap == 0.0, (g, k, gap, moved)
    rows_mesh, rows_single = _rows(runs["mesh"]), _rows(runs["single"])
    assert len(rows_mesh) == len(rows_single) == 1
    assert rows_mesh[0].keys() == rows_single[0].keys()
    for k, v in rows_single[0].items():
        assert float(rows_mesh[0][k]) == pytest.approx(float(v), rel=STATS_TOL, abs=1e-6), k
    with open(os.path.join(runs["mesh"], "train.log")) as f:
        assert sum("epoch 0 |" in line for line in f) == 1


def test_mesh_checkpoint_loads_in_the_inference_cli_and_a_single_process_run(runs, tmp_path,
                                                                            capsys):
    ckpts = os.path.join(runs["mesh"], "checkpoints")
    inference.main(["--family", "vgan", "--stage", "1", "--preset", "tiny",
                    "--dataset", "synthetic", "--device", "cpu", "--no-is",
                    "--ckpt", ckpts, "-o", str(tmp_path / "inference")])
    assert "pcc" in capsys.readouterr().out.lower()
    run.main([*BASE, "--stage", "1", "-o", str(tmp_path), "--resume-dir", runs["mesh"],
              "--evaluate"])
    assert "valid_PCC" in capsys.readouterr().out
