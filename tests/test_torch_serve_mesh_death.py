"""A serving mesh whose rank dies stops: ``python -m fmri_tpu_torch.eval.serve
--device cpu --mesh data=2,model=2`` watches every rank it started at once,
so when its last rank is killed the CLI exits non-zero within seconds rather
than serving on beside a dead peer (rank 0's batcher turns each failed
collective into an error reply and keeps going)."""

import os
import re
import signal
import subprocess
import sys

import pytest
import torch

from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.configs import get_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# from the kill to the CLI's exit
EXIT_WITHIN_S = 10.0


def test_killing_the_last_rank_stops_the_mesh_cli(tmp_path):
    cfg = get_config("tiny")
    kind = "vae-gan-cognitive-eval"
    sd = convert.from_jax_groups(convert.random_groups(cfg, seed=3, kind=kind), cfg, kind)
    ckpt = str(tmp_path / "a.pth")
    torch.save({k: v for k, v in sd.items() if not k.startswith(convert.UNUSED_PREFIXES)},
               ckpt)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fmri_tpu_torch.eval.serve", "--family", "vgan", "--stage",
         "3", "--preset", "tiny", "--ckpt", ckpt, "--max-batch", "8", "--unix-socket",
         str(tmp_path / "mesh.sock"), "--device", "cpu", "--mesh", "data=2,model=2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        seen, pids = [], {}
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("mesh: "):
                pids = {int(r): int(p) for r, p in re.findall(r"rank (\d+) is process (\d+)",
                                                              line)}
            if line.startswith("serving "):
                break
        assert sorted(pids) == [1, 2, 3], seen
        assert seen[-1].startswith("serving "), seen
        os.kill(pids[3], signal.SIGKILL)
        try:
            code = proc.wait(timeout=EXIT_WITHIN_S)
        except subprocess.TimeoutExpired:
            pytest.fail(f"the CLI still runs {EXIT_WITHIN_S} s after its rank 3 died")
        rest = proc.stdout.read()
        assert code != 0, rest
        assert "rank 3 exited with code -9; stopping" in rest, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in pids.values():
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
