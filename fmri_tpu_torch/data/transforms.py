"""Eval-time image transforms on NHWC tensors (``fmri_tpu/data/transforms.py``
:92-164). The training augmentations wait for the training slice."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _channel(v: Sequence[float], x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def normalize(x: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """Per-channel (x - mean) / std on NHWC images in [0, 1]."""
    return (x - _channel(mean, x)) / _channel(std, x)


def denormalize(x: torch.Tensor, mean: Sequence[float],
                std: Sequence[float]) -> torch.Tensor:
    return x * _channel(std, x) + _channel(mean, x)


def eval_preprocess(x: torch.Tensor, mean: Sequence[float] = (0.5, 0.5, 0.5),
                    std: Sequence[float] = (0.5, 0.5, 0.5)) -> torch.Tensor:
    """uint8 images are dequantized (x / 255) first, then normalized."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    return normalize(x, mean, std)


def resize_batch(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear NHWC resize to (size, size) with half-pixel centres; matches
    ``jax.image.resize(..., 'bilinear')`` when upsampling (reconstructions
    are saved at 200 px, ``inference_gan.py:273-275``)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()
