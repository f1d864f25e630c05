"""The serve CLI over a mesh on the CPU: ``python -m fmri_tpu_torch.eval.serve
--device cpu --mesh data=2,model=2`` starts its other three ranks itself
(gloo), serves as rank 0 on a Unix socket and answers like the
single-process server of the same weights and seed: requests of one row
through the batcher (uint8, 1 LSB: a batch's rows may fall in another
bucket), ``generate`` (the same draws), a reload through the socket and one
refused; Ctrl-C on rank 0 stops every rank and exits 0.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.configs import get_config
from fmri_tpu_torch.eval.client import ServeClient, ServeError
from fmri_tpu_torch.eval.serve import ServingModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pth(path, seed, kind="vae-gan-cognitive-eval"):
    cfg = get_config("tiny")
    sd = convert.from_jax_groups(convert.random_groups(cfg, seed=seed, kind=kind), cfg, kind)
    torch.save({k: v for k, v in sd.items() if not k.startswith(convert.UNUSED_PREFIXES)},
               path)
    return path


def _lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_mesh_cli_answers_like_the_single_process_server(tmp_path):
    first, second = _pth(str(tmp_path / "a.pth"), 3), _pth(str(tmp_path / "b.pth"), 4)
    wrong = _pth(str(tmp_path / "w.pth"), 5, "vae-gan")
    sock = str(tmp_path / "mesh.sock")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fmri_tpu_torch.eval.serve", "--family", "vgan", "--stage",
         "3", "--preset", "tiny", "--ckpt", first, "--max-batch", "8", "--unix-socket",
         sock, "--device", "cpu", "--mesh", "data=2,model=2", "--seed", "7"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("serving "):
                break
        assert seen and seen[-1].startswith(
            f"serving vgan stage 3 (tiny) on {sock} over a mesh data=2,model=2"), seen
        assert any(line.startswith("warmup: 3 buckets") for line in seen), seen  # 2, 4, 8
        single = ServingModel.from_checkpoint(first, "vgan", 3, "tiny", max_batch=8,
                                              min_bucket=2, seed=7, output="uint8",
                                              device="cpu")
        x = np.random.default_rng(1).normal(
            size=(5, *single.sample_shape())).astype(np.float32)
        with ServeClient(unix_path=sock, pool=2) as c:
            assert _lsb(c.reconstruct(x), single.reconstruct(x)) <= 1
            assert _lsb(c.generate(5), single.generate(5)) <= 1
            assert c.reload(second) == {"reloaded": second, "epoch": None}
            single.reload(second)
            assert _lsb(c.reconstruct(x), single.reconstruct(x)) <= 1
            with pytest.raises(ServeError, match="other keys"):
                c.reload(wrong)
            assert _lsb(c.reconstruct(x[:2]), single.reconstruct(x[:2])) <= 1
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
