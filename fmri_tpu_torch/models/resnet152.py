"""torchvision's ResNet-152 trunk in eval mode, over exported torchvision
weights: the port's counterpart of ``fmri_tpu/models/resnet152.py``.

The reference's ``ResNet_VAE`` encoder (dead code upstream,
``vae_gan.py:658-702``) wraps torchvision's *pretrained* ``resnet152``
without its classifier (``list(resnet.children())[:-1]``: everything
through the global average pool, a 2048-d feature). The weights are not
shipped; export them once where torchvision can fetch them:

    import numpy as np, torchvision
    m = torchvision.models.resnet152(weights="IMAGENET1K_V1").eval()
    np.savez("resnet152.npz",
             **{k: v.numpy() for k, v in m.state_dict().items()})

then point ``FMRI_TPU_RESNET152_NPZ`` at the file and build
``ResNetEncoder(cfg, trunk=resnet152_trunk_fn())``. ``fc.*`` and
``num_batches_tracked`` are dropped, as the JAX loader drops them.

The trunk is a frozen feature extractor, as the JAX package closes over its
weights instead of making them parameters: here every weight is a
non-persistent buffer under torchvision's own name (``conv1.weight``,
``layer2.0.downsample.1.running_var``, ...), so it moves with ``.to()``,
takes no gradient and stays out of the encoder's state dict. BatchNorm runs
on the running statistics (eps 1e-5); the convs are ``F.conv2d`` (cuDNN on
the card, TF32 off as ``resolve_device`` sets it); the stem's max pool is
3x3 stride 2 with 1 of padding. Images come in NHWC.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Bottleneck blocks per stage; planes 64/128/256/512, expansion 4
RESNET152_LAYERS: Tuple[int, int, int, int] = (3, 8, 36, 3)
EXPANSION = 4
BN_EPS = 1e-5


class _Frozen(nn.Module):
    """Named tensors as non-persistent buffers."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_buffer(name, torch.zeros(shape), persistent=False)


class Conv(_Frozen):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__(weight=(cout, cin, k, k))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)


class BatchNorm(_Frozen):
    def __init__(self, c: int):
        super().__init__(weight=(c,), bias=(c,), running_mean=(c,), running_var=(c,))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=BN_EPS)


class Bottleneck(nn.Module):
    """1x1, 3x3 (stride), 1x1 x4 convs, each with BatchNorm; a strided 1x1
    conv + BatchNorm shortcut (``downsample``) where the shape changes."""

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3, stride, 1), BatchNorm(planes)
        self.conv3 = Conv(planes, planes * EXPANSION, 1)
        self.bn3 = BatchNorm(planes * EXPANSION)
        if stride != 1 or cin != planes * EXPANSION:
            self.downsample = nn.Sequential(Conv(cin, planes * EXPANSION, 1, stride),
                                            BatchNorm(planes * EXPANSION))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(y + identity)


class ResNetTrunk(nn.Module):
    """conv1 .. layer4 and the global average pool: NHWC images -> [B, 2048]
    (``fmri_tpu/models/resnet152.py:62-91``)."""

    def __init__(self, layers: Tuple[int, ...] = RESNET152_LAYERS):
        super().__init__()
        self.conv1, self.bn1 = Conv(3, 64, 7, 2, 3), BatchNorm(64)
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, planes, 2 if b == 0 and li > 1 else 1))
                cin = planes * EXPANSION
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).contiguous()
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(h))), 3, 2, 1)
        for li in range(1, 5):
            h = getattr(self, f"layer{li}")(h)
        return h.mean(dim=(2, 3))

    @torch.no_grad()
    def load_weights(self, weights: Dict[str, np.ndarray]) -> "ResNetTrunk":
        """Copy a torchvision state dict into the buffers: ``fc.*`` and
        ``num_batches_tracked`` dropped, every other key must be a buffer of
        the trunk and every buffer must be given (same shape)."""
        own = dict(self.named_buffers())
        given = {k: v for k, v in weights.items()
                 if not (k.startswith("fc.") or k.endswith("num_batches_tracked"))}
        if set(given) != set(own):
            diff = sorted(set(given) ^ set(own))
            raise KeyError(f"resnet weights do not match the trunk: {diff[:6]} ...")
        for k, buf in own.items():
            v = torch.as_tensor(np.asarray(given[k]))
            if tuple(v.shape) != tuple(buf.shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)}, want {tuple(buf.shape)}")
            buf.copy_(v)
        return self


def resnet152_npz_path() -> str | None:
    """The export location, or None when only the from-scratch trunk exists."""
    return os.environ.get("FMRI_TPU_RESNET152_NPZ") or None


def load_trunk(npz_path: str, layers: Tuple[int, ...] = RESNET152_LAYERS) -> ResNetTrunk:
    """The trunk of ``layers`` on the CPU with the weights of ``npz_path``."""
    with np.load(npz_path) as raw:
        return ResNetTrunk(layers).load_weights({k: raw[k] for k in raw.files}).eval()


def resnet152_trunk_fn(npz_path: str | None = None,
                       layers: Tuple[int, ...] = RESNET152_LAYERS) -> ResNetTrunk:
    """The ``trunk`` of :class:`fmri_tpu_torch.models.nets.ResNetEncoder`:
    frozen pretrained features [B, 2048] from exported torchvision
    weights (``FMRI_TPU_RESNET152_NPZ`` unless ``npz_path``)."""
    path = npz_path or resnet152_npz_path()
    if path is None:
        raise ValueError("no resnet152 npz: set FMRI_TPU_RESNET152_NPZ or pass npz_path")
    return load_trunk(path, layers)


def random_weights(seed: int = 0, layers: Tuple[int, ...] = RESNET152_LAYERS
                   ) -> Dict[str, np.ndarray]:
    """Seeded numpy weights in torchvision's layout for a trunk of
    ``layers`` (and ``fc``, which the loader drops), for running it without
    the pretrained file: unit-gain convs, BatchNorm scales near 1 with
    random shifts and statistics (variances in [0.5, 1.5]), so a
    mis-consumed tensor shows."""
    rng = np.random.default_rng(seed)
    out = {}
    with torch.device("meta"):  # names and shapes only
        trunk = ResNetTrunk(layers)
    for k, v in trunk.named_buffers():
        shape = tuple(v.shape)
        if len(shape) == 4:
            w = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        elif k.endswith("running_var"):
            w = rng.uniform(0.5, 1.5, shape)
        else:  # BatchNorm weight (near 1; the block's last one small), bias, mean
            base = 1.0 if k.endswith("weight") and not k.endswith("bn3.weight") else 0.0
            w = base + rng.normal(0.0, 0.1, shape)
        out[k] = w.astype(np.float32)
    out["fc.weight"] = rng.normal(0.0, 0.01, (1000, 512 * EXPANSION)).astype(np.float32)
    out["fc.bias"] = np.zeros(1000, np.float32)
    return out
