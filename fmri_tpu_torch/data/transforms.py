"""Image transforms on NHWC tensors, run on the batch's device
(``fmri_tpu/data/transforms.py:92-164``): normalization, the eval
preprocess, the bilinear resize, and the train-time augmentation (flip,
integer shift with nearest-edge fill, normalize).

The augmentation's random parts come from the caller as tensors, a flip
mask [B] and integer shifts [B, 2] (the trainer's draws), so the tests can
inject the JAX draws and a resumed run can redraw exactly."""

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


def random_flip_batch(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the samples where the bool mask ``flip`` [B] is
    set (``transforms.RandomHorizontalFlip`` with p = 0.5 in the stage-I
    train pipeline, ``train_vgan_stage1.py:166``; the trainer draws the
    mask). NHWC."""
    return torch.where(flip.view(-1, 1, 1, 1), x.flip(2), x)


def random_shift_batch(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-sample integer translation by ``shifts`` [B, 2] = (dy, dx) with
    nearest-edge fill: out[b, i, j] = x[b, clip(i - dy), clip(j - dx)], the
    clamped gather of ``fmri_tpu/data/transforms.py:_shift_one``
    (``scipy.ndimage.shift(order=0, mode='nearest')``, the reference's
    ``rand_shift``, ``data_loader.py:206-217``). NHWC."""
    b, h, w = x.shape[:3]
    rows = (torch.arange(h, device=x.device) - shifts[:, :1]).clamp(0, h - 1)
    cols = (torch.arange(w, device=x.device) - shifts[:, 1:]).clamp(0, w - 1)
    batch = torch.arange(b, device=x.device).view(-1, 1, 1)
    return x[batch, rows[:, :, None], cols[:, None, :]]


def train_augment(x: torch.Tensor, flip: torch.Tensor | None = None,
                  shifts: torch.Tensor | None = None,
                  mean: Sequence[float] = (0.5, 0.5, 0.5),
                  std: Sequence[float] = (0.5, 0.5, 0.5)) -> torch.Tensor:
    """The train-time pipeline on the device: [flip] -> [shift] ->
    normalize. ``flip`` (a bool mask [B]) and ``shifts`` (int [B, 2]) are
    the draws; None skips that transform. Stage-I images take the flip,
    stage-II/III pairs the shift (max 5), eval neither. uint8 batches (a
    packed dataset, shipped undecoded) are dequantized here first."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    if flip is not None:
        x = random_flip_batch(x, flip)
    if shifts is not None:
        x = random_shift_batch(x, shifts)
    return normalize(x, mean, std)


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
