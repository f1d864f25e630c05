"""The auxiliary losses of the reference's shared library
(``train/train_utils.py:72-264``): available but unused by the main
trainers, kept for the Beliy-style self-supervision experiments. The
port's counterpart of ``fmri_tpu/losses/aux_losses.py``.

Images are NHWC and voxel vectors [B, V], as in the JAX package. The
VGG19-feature losses tap torchvision's *pretrained* VGG19 in the reference;
the feature extractor is chosen in the JAX order: a ``feature_fn`` passed
in; else VGG19 over the weights ``FMRI_TPU_VGG19_NPZ`` names
(``losses/vgg19.py``); else a fixed-seed conv proxy, whose weights numpy
draws exactly as the JAX package does (``default_rng(0)``, HWIO, here
transposed to OIHW), so the proxy is the same function in both packages.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PROXY_CHANNELS = (32, 64, 128, 128, 128)


def _cosine_rows(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity over the flattened trailing dims:
    sum(a * b) / max(|a| |b|, eps), the JAX formula (not
    ``F.cosine_similarity``, which clamps each norm)."""
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    num = torch.sum(a * b, dim=1)
    den = torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1)
    return num / torch.clamp(den, min=eps)


def voxel_loss(y_pred: torch.Tensor, y_true: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """MSE + (1 - mean cosine) in voxel space (``VoxelLoss.forward``,
    ``train_utils.py:95-96``); ``alpha`` is stored and unused in the
    reference too."""
    del alpha
    mse = torch.mean((y_pred - y_true) ** 2)
    return mse + (1.0 - torch.mean(_cosine_rows(y_pred, y_true)))


def norm_image_prediction(img: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
                          std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """Per-image, per-channel standardisation (population std, ddof 0, as
    ``jnp.std``), then re-coloured with (mean, std)
    (``train_utils.py:217-231``). NHWC."""
    mu = img.mean(dim=(1, 2), keepdim=True)
    sd = img.std(dim=(1, 2), keepdim=True, correction=0) + 1e-8
    normed = (img - mu) / sd
    return (normed * torch.tensor(std, dtype=img.dtype, device=img.device)
            + torch.tensor(mean, dtype=img.dtype, device=img.device))


def image_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
               mean: Sequence[float] = IMAGENET_MEAN,
               std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """Pixel MSE with the prediction re-normalised to the target statistics
    (``ImageLoss.forward``, ``train_utils.py:116-129``)."""
    return torch.mean((norm_image_prediction(y_pred, mean, std) - y_true) ** 2)


@lru_cache(maxsize=2)
def _proxy_weights(channels: tuple, seed: int = 0) -> tuple:
    """The proxy's conv kernels, drawn as ``fmri_tpu/losses/aux_losses.py:66-76``
    draws them (HWIO normals of std sqrt(2 / (9 cin))), as OIHW float32."""
    rng = np.random.default_rng(seed)
    out, cin = [], 3
    for cout in channels:
        w = rng.normal(0.0, (2.0 / (9 * cin)) ** 0.5, (3, 3, cin, cout))
        out.append(torch.from_numpy(w.astype(np.float32).transpose(3, 2, 0, 1).copy()))
        cin = cout
    return tuple(out)


def proxy_feature_fn(images: torch.Tensor, depth: int = 2) -> torch.Tensor:
    """Deterministic random conv features standing in for VGG19 taps:
    ``depth`` 3x3 stride-2 convs (padding 1) with ReLU. NHWC in and out."""
    x = images.permute(0, 3, 1, 2)
    for w in _proxy_weights(PROXY_CHANNELS)[:depth]:
        x = torch.relu(F.conv2d(x, w.to(x.device, x.dtype), stride=2, padding=1))
    return x.permute(0, 2, 3, 1)


def _default_feature_fn(depth: int) -> Callable:
    """VGG19 at tap ``depth`` when ``FMRI_TPU_VGG19_NPZ`` is set, else the proxy."""
    from fmri_tpu_torch.losses.vgg19 import vgg19_npz_path, vgg19_tap_fn

    if vgg19_npz_path() is not None:
        return vgg19_tap_fn(depth)
    return lambda x: proxy_feature_fn(x, depth)


def feature_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                 feature_fn: Optional[Callable] = None, depth: int = 2,
                 mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """RMSE between feature activations of the re-normalised prediction and
    the target (``ImageLoss.vgg_loss``, ``train_utils.py:131-159``; its
    conv1/conv2 taps are ``depth`` 1/2)."""
    if feature_fn is None:
        feature_fn = _default_feature_fn(depth)
    fp = feature_fn(norm_image_prediction(y_pred, mean, std))
    return torch.sqrt(torch.mean((fp - feature_fn(y_true)) ** 2))


def feature_cosine_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                        feature_fn: Optional[Callable] = None,
                        depths: Sequence[int] = (1, 2, 3, 4, 5)) -> torch.Tensor:
    """Minus the summed mean cosine similarity over feature depths
    (``ImageLoss.vgg_cosine_loss``, ``train_utils.py:161-178``: the five
    VGG19 taps, ``vgg19.TAPS``)."""
    total = torch.zeros((), device=y_pred.device)
    for d in depths:
        fn = feature_fn or _default_feature_fn(d)
        total = total - torch.mean(_cosine_rows(fn(y_pred), fn(y_true)))
    return total


# ------------------------- total-variation family -------------------------
# reference train_utils.py:243-264, NHWC


def _diffs(x: torch.Tensor):
    base = x[:, :-1, :-1, :]
    return base - x[:, 1:, :-1, :], base - x[:, :-1, 1:, :]


def total_variation_loss(x: torch.Tensor) -> torch.Tensor:
    a, b = (torch.sqrt(torch.abs(d) + 1e-12) for d in _diffs(x))
    return torch.mean((a + b) ** 1.25)


def total_variation_l1(x: torch.Tensor) -> torch.Tensor:
    a, b = _diffs(x)
    return torch.mean(torch.abs(a) + torch.abs(b))


def total_variation_l2(x: torch.Tensor) -> torch.Tensor:
    a, b = _diffs(x)
    return torch.mean(torch.sqrt(a ** 2 + b ** 2 + 1e-12))
