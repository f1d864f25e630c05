"""Everything a run feeds the program and the reference, made from ``--seed``
on the device in a few large calls: weights, BatchNorm statistics, images,
fMRI scans and noise.

The image and pair generators stand in for ``fmri_tpu_torch/data/synthetic.py``
(``synthetic_images``: a Python loop over images, minutes of set-up at
100 px and thousands of images): smooth colour fields at two scales plus
fine grain, quantized to uint8 as a packed COCO set is; the scans are a
linear encoding of each image's coarse content plus noise, z-scored per
voxel, as ``synthetic_pairs`` makes them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the generator streams of one seed
WEIGHTS, IMAGES, SCANS, STEPS, ARRIVALS, SAMPLE = range(6)


def word(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of ``seed`` (any non-negative integer)."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(word(seed, stream))


def weights(specs: List[Tuple[str, tuple, str]], seed: int, device) -> Dict[str, torch.Tensor]:
    """The thesis's init (vae_gan.py:252-264) from ``seed``: every conv,
    transposed conv and linear weight U(-a, a), a = 1/sqrt(3 * fan_in) over
    the input channels and taps, from one uniform draw; biases 0; BatchNorm
    scale 1, shift 0, running statistics 0 and 1."""
    drawn = [(k, s) for k, s, kind in specs if kind in ("conv", "deconv", "linear")]
    flat = torch.rand(sum(int(np.prod(s)) for _, s in drawn),
                      generator=generator(seed, WEIGHTS, device), device=device)
    out, at = {}, 0
    for key, shape, kind in specs:
        if kind in ("conv", "deconv", "linear"):
            n = int(np.prod(shape))
            fan_in = int(np.prod(shape[1:])) if kind != "deconv" else shape[0] * shape[2] * shape[3]
            a = (3.0 * fan_in) ** -0.5
            out[key] = (flat[at:at + n].view(shape) * 2.0 - 1.0) * a
            at += n
        elif kind == "count":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in ("bn_weight", "running_var"):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    return out


def images(n: int, size: int, seed: int, device, chunk: int = 1024) -> np.ndarray:
    """``n`` uint8 NHWC images on the host."""
    g = generator(seed, IMAGES, device)
    out = np.empty((n, size, size, 3), np.uint8)
    for lo in range(0, n, chunk):
        k = min(chunk, n - lo)
        coarse = torch.rand((k, 3, 5, 5), generator=g, device=device)
        mid = torch.rand((k, 3, max(size // 8, 2), max(size // 8, 2)), generator=g, device=device)
        grain = torch.rand((k, 3, size, size), generator=g, device=device) - 0.5
        x = (0.7 * F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
             + 0.3 * F.interpolate(mid, size=(size, size), mode="bilinear", align_corners=False)
             + 0.1 * grain)
        x = (x.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        out[lo:lo + k] = x.permute(0, 2, 3, 1).cpu().numpy()
    return out


def _zscore(v: torch.Tensor) -> torch.Tensor:
    return (v - v.mean(0)) / (v.std(0) + 1e-8)


def scans_of(imgs: np.ndarray, num_voxels: int, seed: int, device,
             noise: float = 0.5, chunk: int = 2048) -> np.ndarray:
    """fMRI scans [n, V] float32 for the uint8 images ``imgs``: each image's
    4x4 mean colours (48 features) through a fixed random map to the
    voxels, plus noise, z-scored per voxel."""
    g = generator(seed, SCANS, device)
    w = torch.randn((48, num_voxels), generator=g, device=device)
    rows = []
    for lo in range(0, len(imgs), chunk):
        x = torch.from_numpy(imgs[lo:lo + chunk]).to(device).permute(0, 3, 1, 2).float() / 255.0
        f = F.adaptive_avg_pool2d(x, 4).reshape(len(x), -1) - 0.5
        rows.append(f @ w + noise * torch.randn((len(x), num_voxels), generator=g, device=device))
    return _zscore(torch.cat(rows)).cpu().numpy()


def scans(n: int, num_voxels: int, seed: int, device) -> np.ndarray:
    """``n`` scans [n, V] float32 on the host, with the images behind them
    drawn at 16 px (only their coarse content reaches the voxels)."""
    return scans_of(images(n, 16, seed, device), num_voxels, seed, device)
