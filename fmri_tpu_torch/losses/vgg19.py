"""torchvision's VGG19 ``features`` trunk as ``nn.Module``s over exported
torchvision weights: the port's counterpart of ``fmri_tpu/losses/vgg19.py``.

The reference's ``ImageLoss.vgg_loss`` / ``vgg_cosine_loss``
(``train/train_utils.py:131-178``) tap torchvision's *pretrained*
``vgg19().features`` at fixed sequential indices: ``features[:4]`` (through
relu1_2), ``[:9]`` (relu2_2), and for the cosine loss ``[:14] [:18] [:23]``
too (:data:`TAPS`). The weights are not shipped; export them once where
torchvision can fetch them:

    import numpy as np, torchvision
    m = torchvision.models.vgg19(weights="IMAGENET1K_V1").features.eval()
    np.savez("vgg19_features.npz",
             **{k: v.numpy() for k, v in m.state_dict().items()})

then point ``FMRI_TPU_VGG19_NPZ`` at the file. Keys may carry the
whole-model ``features.`` prefix or not; ``classifier.*`` (and any other
key that is not a ``features`` index) is dropped, as the JAX loader does.
:class:`VGG19Features` is an ``nn.Sequential`` of torchvision's cfg "E"
(a 3x3 conv with bias and a ReLU per entry, 2x2 max pools), so the file
loads into it with ``strict=True``; its weights take no gradient (the loss
network is frozen; gradients flow to the images). Images come and
activations go in NHWC, the JAX module's layout; the convs are cuDNN calls
on the card.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict

import numpy as np
import torch
from torch import nn

CFG_E = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
# the five tap depths of the reference (train_utils.py:131-178): sequential
# slice ends, TAPS[d] for the feature losses' ``depth`` 1..5
TAPS = {1: 4, 2: 9, 3: 14, 4: 18, 5: 23}


class VGG19Features(nn.Sequential):
    """torchvision's ``vgg19().features``; ``forward(x, upto)`` runs
    ``features[:upto]`` on NHWC ``x`` and returns NHWC."""

    def __init__(self):
        layers, cin = [], 3
        for c in CFG_E:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
                cin = c
        super().__init__(*layers)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, upto: int = len(CFG_E) * 2) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).contiguous()
        for layer in list(self)[:upto]:
            h = layer(h)
        return h.permute(0, 2, 3, 1)


def state_from_npz(npz_path: str) -> Dict[str, torch.Tensor]:
    """The ``features`` tensors of an exported state dict, keys without the
    ``features.`` prefix (``fmri_tpu/losses/vgg19.py:87-99``)."""
    out = {}
    with np.load(npz_path) as raw:
        for k in raw.files:
            name = k[len("features."):] if k.startswith("features.") else k
            if name.split(".")[0].isdigit():
                out[name] = torch.from_numpy(raw[k])
    return out


@lru_cache(maxsize=2)
def load_model(npz_path: str, device: torch.device) -> VGG19Features:
    """The trunk loaded strictly from ``npz_path``, in eval mode on ``device``."""
    model = VGG19Features()
    model.load_state_dict(state_from_npz(npz_path), strict=True)
    return model.eval().to(device)


def vgg19_npz_path() -> str | None:
    """The export location, or None when only the proxy extractor exists."""
    return os.environ.get("FMRI_TPU_VGG19_NPZ") or None


def vgg19_tap_fn(depth: int, npz_path: str | None = None):
    """``feature_fn`` for ``aux_losses.feature_loss`` /
    ``feature_cosine_loss``: VGG19 activations at the reference's tap
    ``depth`` (1..5, :data:`TAPS`), on the images' device."""
    path = npz_path or vgg19_npz_path()
    if path is None:
        raise ValueError("no VGG19 npz: set FMRI_TPU_VGG19_NPZ or pass npz_path")
    upto = TAPS[depth]
    return lambda images: load_model(path, images.device)(images, upto)


def random_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded numpy weights in torchvision's ``features`` layout, for running
    the trunk without the pretrained file: unit-gain convs (std
    1/sqrt(9 cin)), biases N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    out, cin, i = {}, 3, 0
    for c in CFG_E:
        if c == "M":
            i += 1
            continue
        out[f"{i}.weight"] = rng.normal(0, 1.0 / np.sqrt(9 * cin), (c, cin, 3, 3)).astype(
            np.float32)
        out[f"{i}.bias"] = rng.normal(0, 0.05, c).astype(np.float32)
        cin, i = c, i + 2
    return out
