"""Reconstruction-quality metrics: PCC, MSE, windowed SSIM, the n-way
objective identification and the Inception Score from class probabilities.
Images are NHWC float tensors.

Counterpart of ``fmri_tpu/metrics/quality.py``. The objective assessment
draws its distractors with the same ``np.random.default_rng(seed)`` sequence
as the reference, so the indices match exactly; where the reference vmaps a
per-pair SSIM, this builds the (recon, gt) and (recon, distractor) pairs as
one batch and takes every per-pair SSIM from one ``size_average=False`` call
(one kernel launch on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from fmri_tpu_torch.ops.ssim import gaussian_window, ssim  # noqa: F401


def pearson_correlation(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """Global Pearson correlation over the whole tensor
    (``train_utils.py:267-292``: the reference subtracts the global mean)."""
    vx = y_pred - y_pred.mean()
    vy = y_true - y_true.mean()
    return (vx * vy).sum() / (torch.sqrt((vx**2).sum()) * torch.sqrt((vy**2).sum()))


def mse(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """``nn.MSELoss`` (mean reduction)."""
    return ((y_pred - y_true) ** 2).mean()


def distractor_indices(n: int, top: int, seed: int = 0) -> np.ndarray:
    """[n, top-1] distractor indices, never the image itself, drawn exactly
    as ``fmri_tpu.metrics.quality.objective_assessment`` draws them."""
    rng = np.random.default_rng(seed)
    idx = np.empty((n, top - 1), dtype=np.int64)
    for i in range(n):
        choices = np.delete(np.arange(n), i)
        idx[i] = rng.choice(choices, size=top - 1, replace=True)
    return idx


def objective_assessment(out: torch.Tensor, target: torch.Tensor, top: int = 5,
                         seed: int = 0, ssim_fn=ssim) -> np.ndarray:
    """n-way identification (``train_utils.py:752-816``): the fraction of
    reconstructions that beat all ``top-1`` distractor ground truths on PCC
    and, independently, on SSIM. Returns ``[score_pcc, score_ssim]``; chance
    is 1/top. ``ssim_fn`` lets a check run the same pairs through
    :func:`fmri_tpu_torch.ops.ssim.ssim_plain`."""
    n = out.shape[0]
    idx = torch.from_numpy(distractor_indices(n, top, seed)).to(out.device)
    # per-image PCC against every target: P[i, j] = pcc(out[i], target[j])
    r = out.reshape(n, -1)
    t = target.reshape(n, -1)
    r = r - r.mean(dim=1, keepdim=True)
    t = t - t.mean(dim=1, keepdim=True)
    p = (r @ t.T) / (r.norm(dim=1)[:, None] * t.norm(dim=1)[None, :])
    wins_pcc = (p.diagonal()[:, None] > p.gather(1, idx)).all(dim=1)
    # per-pair SSIM: n (recon, gt) pairs then n*(top-1) (recon, distractor)
    flat = idx.reshape(-1)
    img1 = torch.cat([out, out.repeat_interleave(top - 1, dim=0)])
    img2 = torch.cat([target, target[flat]])
    s = ssim_fn(img1, img2, size_average=False)
    s_gt, s_rand = s[:n], s[n:].reshape(n, top - 1)
    wins_ssim = (s_gt[:, None] > s_rand).all(dim=1)
    return np.array([wins_pcc.double().mean().item(),
                     wins_ssim.double().mean().item()])


def inception_score_from_probs(probs: np.ndarray, splits: int = 1):
    """IS = exp(mean_x KL(p(y|x) || p(y))) over splits; returns ``(mean,
    std)`` over splits like the reference (``train_utils.py:869-881``). numpy
    on ``probs`` ([N, num_classes] softmax outputs, in their own dtype), the
    arithmetic of ``fmri_tpu/metrics/quality.py:134-146``."""
    n = probs.shape[0]
    scores = []
    for k in range(splits):
        part = probs[k * (n // splits): (k + 1) * (n // splits)]
        py = np.mean(part, axis=0)
        kl = np.sum(part * (np.log(part + 1e-12) - np.log(py + 1e-12)), axis=1)
        scores.append(np.exp(np.mean(kl)))
    return float(np.mean(scores)), float(np.std(scores))
