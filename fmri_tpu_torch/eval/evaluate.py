"""Full-dataset evaluation: reconstructions, PCC / SSIM / MSE / Inception
Score, the n-way objective identification, and their CSV, bar-chart and
PNG artifacts.

Counterpart of ``fmri_tpu/eval/evaluate.py:32-148``. Reconstructions stay on
the model's device, so on the card the metrics (the SSIM kernel, the IS
classifier) run there with no host round trip.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from fmri_tpu_torch.data.transforms import denormalize, normalize, resize_batch
from fmri_tpu_torch.eval.steps import VaeGanCognitive, VaeGanVisual
from fmri_tpu_torch.metrics.inception import inception_score
from fmri_tpu_torch.metrics.quality import mse, objective_assessment, pearson_correlation, ssim


def _to_device(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.tensor(np.asarray(a), device=device)  # copies: memmaps are read-only


def reconstruct_dataset(model: VaeGanCognitive | VaeGanVisual,
                        batches: Iterable[Dict], *,
                        mean: Sequence[float] = (0.5, 0.5, 0.5),
                        std: Sequence[float] = (0.5, 0.5, 0.5),
                        sample: bool = False, seed: int = 0,
                        max_batches: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reconstruct every batch (numpy or tensors): a ``VaeGanCognitive``
    from the fMRI of ``{"fmri", "image"}`` batches, a ``VaeGanVisual``
    from the normalized image of ``{"image"}`` batches. Returns (recons,
    targets): denormalized NHWC float32 tensors on the model's device;
    uint8 targets are dequantized to [0, 1]. With ``sample`` the latent is
    mu + eps * exp(logvar / 2), eps drawn from a ``torch.Generator`` seeded
    with ``seed``."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed) if sample else None
    recons, targets = [], []
    for i, batch in enumerate(batches):
        if max_batches and i >= max_batches:
            break
        target = _to_device(batch["image"], device)
        if target.dtype == torch.uint8:
            target = target.float() / 255.0
        x = (normalize(target, mean, std) if isinstance(model, VaeGanVisual)
             else _to_device(batch["fmri"], device).float())
        eps = None
        if gen is not None:
            eps = torch.randn((x.shape[0], model.cfg.latent_dim),
                              generator=gen, device=device)
        recon = model.reconstruct(x, eps)
        recons.append(denormalize(recon, mean, std))
        targets.append(target)
    return torch.cat(recons), torch.cat(targets)


def quality_metrics(recons: torch.Tensor, targets: torch.Tensor, *,
                    with_is: bool = True, ssim_fn=ssim) -> Dict[str, float]:
    """Mean PCC / SSIM / MSE over the full arrays (``train_utils.py:678-749``),
    and with ``with_is`` the Inception Score of the reconstructions
    (``is_mean``, ``is_std``, ``is_proxy`` as a float). The classifier sees
    the denormalized reconstructions as they are, as the JAX function feeds
    it (``fmri_tpu/eval/evaluate.py:81``). ``ssim_fn`` lets a check
    substitute the plain SSIM for the kernel."""
    out = {"pcc": float(pearson_correlation(recons, targets)),
           "ssim": float(ssim_fn(recons, targets)),
           "mse": float(mse(recons, targets))}
    if with_is:
        is_mean, is_std, proxy = inception_score(recons)
        out.update(is_mean=is_mean, is_std=is_std, is_proxy=float(proxy))
    return out


def objective_scores(recons: torch.Tensor, targets: torch.Tensor,
                     tops: Sequence[int] = (2, 5, 10), seed: int = 0, *,
                     ssim_fn=ssim) -> Dict[str, list]:
    """n-way identification table (``inference_gan.py:283-298``):
    {'top': [...], 'pcc': [...], 'ssim': [...]}, chance = 1/top."""
    out = {"top": [], "pcc": [], "ssim": []}
    for top in tops:
        s = objective_assessment(recons, targets, top=top, seed=seed,
                                 ssim_fn=ssim_fn)
        out["top"].append(top)
        out["pcc"].append(float(s[0]))
        out["ssim"].append(float(s[1]))
    return out


def save_objective_csv(scores: Dict[str, list], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(scores))
        w.writeheader()
        for i in range(len(scores["top"])):
            w.writerow({k: scores[k][i] for k in scores})


def save_objective_bar_chart(scores: Dict[str, list], path: str) -> None:
    """Bar chart with chance-level lines (``inference_gan.py:288-306``),
    where matplotlib imports; otherwise a line on stdout says so (the CSV
    holds the same scores)."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: no {path} (objective.csv has the scores)")
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    labels = [f"{t}-way" for t in scores["top"]]
    fig = plt.figure()
    bars = plt.bar(labels, scores["pcc"], width=0.5)
    n = len(labels)
    for i, t in enumerate(scores["top"]):
        plt.axhline(y=1.0 / t, xmin=i / n, xmax=(i + 1) / n,
                    linewidth=1, color="k")
    for bar, v in zip(bars, scores["pcc"]):
        plt.text(bar.get_x() + 0.10, v + 0.005, f"{v * 100:.2f}")
    plt.ylabel("Pixel correlation (%)")
    plt.title("Objective assessment")
    fig.savefig(path)
    plt.close(fig)


def save_reconstructions(recons: torch.Tensor, out_dir: str,
                         resize_to: Optional[int] = 200) -> None:
    """Per-image PNG dump, resized like the reference (``:273-275``)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    arr = resize_batch(recons, resize_to) if resize_to else recons
    arr = arr.clamp(0.0, 1.0).cpu().numpy()
    for i, img in enumerate(arr):
        Image.fromarray((img * 255.0 + 0.5).astype(np.uint8)).save(
            os.path.join(out_dir, f"recon_{i:05d}.png"))
