"""Image transforms, a host half and a device half
(``fmri_tpu/data/transforms.py``).

The host half (numpy and PIL, once per image, cacheable; :34-86 there):
decode -> center-crop -> resize -> grey-to-color, fixed-shape float32 HWC in
[0, 1]. PIL is imported inside the functions and called as the JAX package
calls it (uint8 BILINEAR), so the arrays are bitwise the JAX ones.

The device half, on NHWC tensors on the batch's device (:92-164 there):
normalization, the eval preprocess, the bilinear resize, and the train-time
augmentation (flip, integer shift with nearest-edge fill, normalize).

The augmentation's random parts come from the caller as tensors, a flip
mask [B] and integer shifts [B, 2] (the trainer's draws), so the tests can
inject the JAX draws and a resumed run can redraw exactly."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fmri_tpu_torch.device import constant
from fmri_tpu_torch.utils.spans import span

# ------------------------- host-side (numpy / PIL) -------------------------


def center_crop(img: np.ndarray, crop: int) -> np.ndarray:
    """Center crop of an HWC array with the reference's integer-floor window
    (``CenterCrop.__call__``, ``data_loader.py:155-161``); smaller where the
    image is."""
    h, w = img.shape[:2]
    y0 = max(h // 2 - crop // 2, 0)
    x0 = max(w // 2 - crop // 2, 0)
    return img[y0:y0 + crop, x0:x0 + crop]


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of an HWC float array in [0, 1] to (size, size)
    through PIL on uint8, as the reference's torchvision path does
    (``train_vgan_stage1.py:164``); 1 channel becomes 3."""
    from PIL import Image

    if img.ndim == 2:
        img = img[:, :, None]
    arr = np.clip(img, 0.0, 1.0)
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    pil = Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8))
    out = pil.resize((size, size), Image.BILINEAR)
    return np.asarray(out, dtype=np.float32) / 255.0


def grey_to_color(img: np.ndarray) -> np.ndarray:
    """1 channel -> 3 (reference ``GreyToColor``, ``data_loader.py:374-400``);
    RGBA loses its alpha."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    if img.shape[2] == 4:
        return img[:, :, :3]
    return img


def decode_image(path: str) -> np.ndarray:
    """An image file as float32 HWC (3 channels; uint8 files scaled to [0, 1])."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    return grey_to_color(arr)


def load_stimulus(path: str, crop: int, size: int) -> np.ndarray:
    """decode -> center-crop -> resize: a stimulus as [size, size, 3] in [0, 1]."""
    return resize_image(center_crop(decode_image(path), crop), size)


# ------------------------- device-side (torch, batched) -------------------------


def _channel(v: Sequence[float], x: torch.Tensor) -> torch.Tensor:
    """``v`` per channel in ``x``'s dtype on ``x``'s device, made once
    (:func:`~fmri_tpu_torch.device.constant`)."""
    return constant(tuple(v), x.dtype, x.device)


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
    with span("input.augment"):
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
