"""Structured synthetic data for smoke runs and tests: the port's copy of
``fmri_tpu/data/synthetic.py`` (same numpy draws, same arrays).

Images are smooth gradient backgrounds plus a coloured rectangle; fMRI
vectors are a fixed random linear encoding of the image factors plus noise,
z-scored per voxel like the real pipeline's output.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def synthetic_images(n: int, size: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images [n, size, size, 3] in [0, 1], factors [n, 13])."""
    rng = np.random.default_rng(seed)
    # latent factors: bg colors (6), rect color (3), rect geometry (4)
    factors = rng.uniform(0.0, 1.0, (n, 13)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    imgs = np.empty((n, size, size, 3), np.float32)
    for i, f in enumerate(factors):
        c0, c1 = f[0:3], f[3:6]
        grad = (yy[..., None] * c0 + (1.0 - yy)[..., None] * c1)
        rc = f[6:9]
        cx, cy = f[9] * 0.6 + 0.2, f[10] * 0.6 + 0.2
        w, h = f[11] * 0.25 + 0.1, f[12] * 0.25 + 0.1
        mask = ((np.abs(xx - cx) < w) & (np.abs(yy - cy) < h))
        img = grad.copy()
        img[mask] = rc
        imgs[i] = img
    return imgs, factors


def synthetic_pairs(n: int, size: int, num_voxels: int, seed: int = 0,
                    noise: float = 0.05) -> Dict[str, np.ndarray]:
    """{'fmri': [n, V], 'image': [n, S, S, 3]} with fmri = factors @ W + eps,
    z-scored per voxel."""
    imgs, factors = synthetic_images(n, size, seed)
    rng = np.random.default_rng(seed + 1)
    w = rng.normal(0.0, 1.0, (factors.shape[1], num_voxels)).astype(np.float32)
    fmri = factors @ w + noise * rng.normal(size=(n, num_voxels)).astype(np.float32)
    mu, sd = fmri.mean(0), fmri.std(0) + 1e-8
    return {"fmri": ((fmri - mu) / sd).astype(np.float32), "image": imgs}
