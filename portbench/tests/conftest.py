"""Shared pieces of the benchmark's CPU tests: a cell of the benchmark cut to
the ``tiny`` widths, written as files into a temporary benchmark folder."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = os.path.join(ROOT, "portbench")

# the repo's `tiny` preset widths (fmri_tpu_torch/configs/presets.py)
TINY_MODEL = {
    "image_size": 16, "latent_dim": 16, "kernel_size": 5, "stride": 2, "padding": 2,
    "encoder_channels": [8, 16, 16], "decoder_channels": [16, 8, 8, 3],
    "discrim_channels": [8, 16, 16, 16], "fc_input": 2, "fc_output": 32, "fc_input_gan": 2,
    "fc_output_gan": 32, "stride_gan": 1, "output_pad_dec": [True, True, True],
    "recon_level": 3, "num_voxels": 128, "cog_hidden": 32, "wae_disc_hidden": 32,
    "compute_dtype": None, "fused_decoder_batch": False, "pallas_backward": False,
    "alt_backward": False, "pallas_bn": False,
}


def tiny_bench(tmp_path, cell: str, *, compute_dtype=None, batch: int = 8) -> str:
    """A copy of the benchmark folder in which ``cell``'s configuration has
    the tiny widths (``compute_dtype`` as given), 64 images or pairs, and its traffic
    ``batch`` rows (a serving mix: buckets to 16, a pool of 256 scans)."""
    bench = str(tmp_path / "portbench")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(bench, "workloads", cell + ".json")) as f:
        c = json.load(f)
    path = os.path.join(bench, "configs", c["config"] + ".json")
    with open(path) as f:
        config = json.load(f)
    config["model"] = dict(TINY_MODEL, compute_dtype=compute_dtype)
    config["data"]["image_size"] = 16
    config["data"]["num_voxels"] = 128
    config["train_images"] = 64
    config["train_pairs"] = 64
    with open(path, "w") as f:
        json.dump(config, f)
    path = os.path.join(bench, "traffic", c["traffic"] + ".json")
    with open(path) as f:
        traffic = json.load(f)
    if traffic["kind"] == "train_loop":
        traffic["batch"] = batch
    else:
        traffic.update(max_batch=16, pool=256, sample=32, calibration_rows=64,
                       warm_seconds=0.2, rate_per_s=100)
    with open(path, "w") as f:
        json.dump(traffic, f)
    return bench


def run_cell(bench: str, cell: str, seed: int = 2**31 + 11, seconds: float = 0.5,
             trace: bool = False) -> int:
    """One run of ``cell`` from ``bench`` on the CPU (the chip check skipped)."""
    import torch

    from portbench import harness

    c, config, traffic = harness.load_cell(cell, bench)
    kind = harness.traffic_kind(traffic["kind"], bench)
    return kind.run(c, config, traffic, seed=seed, seconds=seconds, trace=trace,
                    device=torch.device("cpu"), bench=bench)


def last_result(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def bench_dir():
    return BENCH
