"""Pluggable Inception-Score classifier, the port's copy of
``fmri_tpu/metrics/inception.py``.

The reference computes IS with torchvision's pretrained Inception-v3
(``train/train_utils.py:819-881``). Pretrained weights are not shipped, so
the scorer is pluggable:

  * If ``FMRI_TPU_INCEPTION_NPZ`` names an existing ``.npz`` of torchvision
    Inception-v3 parameters, those are used
    (:mod:`fmri_tpu_torch.metrics.inception_v3`).
  * Otherwise a small fixed conv classifier (:class:`ProxyClassifier`) gives
    the class probabilities. Its weights are the JAX package's proxy, a flax
    init from ``jax.random.key(1234)`` (``inception.py:71``), written once
    into ``proxy_classifier.npz`` beside this file by
    ``tests/make_torch_proxy_weights.py``, so the port's proxy IS is the JAX
    package's number. It is a *proxy IS*, useful as a relative signal, not
    comparable to published Inception-v3 IS values; ``is_proxy`` says so.

The classifier runs on the images' device (the card, in the inference
CLI); the JAX proxy runs on the host CPU.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fmri_tpu_torch.metrics.quality import inception_score_from_probs

PROXY_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "proxy_classifier.npz")


def same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Zero padding of an NCHW tensor as XLA's (and flax's default)
    ``'SAME'``: ceil(n / stride) outputs, the odd pixel of padding after.
    At stride 2 and an even size that is 0 before and 1 after, which
    ``nn.Conv2d(padding=1)`` would shift."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dimension first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ProxyClassifier(nn.Module):
    """Three 3x3 stride-2 convs (32, 64, 128, with bias, 'SAME' padding),
    ReLU, a spatial mean, a 1000-way linear layer and softmax, as the JAX
    ``ProxyClassifier``. Takes NHWC images, returns probabilities."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, stride=2) for cin, cout in ((3, 32), (32, 64), (64, 128)))
        self.fc = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(same_pad(x, 3, 2)))
        return torch.softmax(self.fc(x.mean(dim=(2, 3))), dim=-1)


@lru_cache(maxsize=4)
def _proxy(device: torch.device) -> ProxyClassifier:
    model = ProxyClassifier()
    with np.load(PROXY_WEIGHTS) as raw:
        model.load_state_dict({k: torch.from_numpy(raw[k]) for k in raw.files}, strict=True)
    return model.eval().to(device)


def _weights_npz():
    npz = os.environ.get("FMRI_TPU_INCEPTION_NPZ")
    return npz if npz and os.path.exists(npz) else None


def classify(images) -> np.ndarray:
    """images: [B, H, W, 3] (a tensor on any device, or numpy) -> probs
    [B, 1000] fp32 numpy. The proxy takes the images at their own size;
    Inception-v3 upsamples them to 299 px."""
    npz = _weights_npz()
    if npz:
        from fmri_tpu_torch.metrics.inception_v3 import classify_with_weights

        return classify_with_weights(npz, images)
    x = torch.as_tensor(images)
    with torch.no_grad():
        return _proxy(x.device)(x.float()).cpu().numpy()


def inception_score(images, splits: int = 1):
    """Inception Score of NHWC images; proxy-backed unless real weights are
    configured (see the module docstring). Returns ``(mean, std,
    is_proxy)``, mean and std over splits like the reference
    (``train_utils.py:879-881``)."""
    mean, std = inception_score_from_probs(classify(images), splits=splits)
    return mean, std, is_proxy()


def is_proxy() -> bool:
    return _weights_npz() is None
