"""torchvision's Inception-v3 eval forward as ``nn.Module``s, over exported
torchvision weights: the port's counterpart of
``fmri_tpu/metrics/inception_v3.py``.

The reference scores IS with torchvision's pretrained
``inception_v3(pretrained=True, transform_input=False)``
(``train/train_utils.py:848-858``). The weights are not shipped; export them
once where torchvision can fetch them:

    import numpy as np, torchvision
    m = torchvision.models.inception_v3(pretrained=True, aux_logits=True).eval()
    np.savez("inception_v3.npz",
             **{k: v.numpy() for k, v in m.state_dict().items()})

and point ``FMRI_TPU_INCEPTION_NPZ`` at the file. Attribute names are
torchvision's (``Conv2d_1a_3x3.conv.weight`` ... ``fc.bias``), so the file
loads with ``strict=True`` once ``AuxLogits.*`` and ``num_batches_tracked``
are dropped, as the JAX loader drops them. Kept from torchvision: BatchNorm
eps 0.001 with running statistics; the branch pools
``avg_pool2d(3, 1, 1)`` counting the padding (divisor 9 at the edges); VALID
3x3 stride-2 max pools; the asymmetric paddings of the 1x7, 7x1, 1x3 and
3x1 convs; a final spatial mean. The convs are ``nn.Conv2d`` (cuDNN on the
card, TF32 off as ``resolve_device`` sets it).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fmri_tpu_torch.data.transforms import resize_batch

BN_EPS = 0.001
INPUT_SIZE = 299


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over running statistics: the four tensors of a
    torchvision ``BatchNorm2d`` without ``num_batches_tracked``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=BN_EPS)


class BasicConv2d(nn.Module):
    """torchvision's ``BasicConv2d``: conv (no bias), BatchNorm, ReLU."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _pool(x):
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_pool(x))], 1)


class InceptionV3(nn.Module):
    """Eval-mode torchvision Inception-v3 without the auxiliary head. Takes
    NCHW images (torchvision's eval input, ``transform_input=False``),
    returns logits [B, 1000]."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, 1000)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3)))


def state_from_npz(npz_path: str) -> dict:
    """The tensors of an exported torchvision state dict, without
    ``AuxLogits.*`` and ``num_batches_tracked`` (``inception_v3.py:164-175``)."""
    with np.load(npz_path) as raw:
        return {k: torch.from_numpy(raw[k]) for k in raw.files
                if not (k.startswith("AuxLogits") or k.endswith("num_batches_tracked"))}


def random_weights(seed: int = 0) -> dict:
    """Seeded numpy weights in torchvision's layout, of the shapes of
    :class:`InceptionV3`'s ``state_dict``, for running the forward without
    the pretrained file: unit-gain convs (std 1/sqrt(fan_in)), BatchNorm
    affines and statistics near identity with positive variances, a small
    ``fc``; activations stay O(1) through the 94 convs."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in InceptionV3().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            w = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        elif k.endswith("running_var"):
            w = rng.uniform(0.5, 1.5, shape)
        elif k == "fc.weight":
            w = rng.normal(0.0, 0.02, shape)
        else:  # BatchNorm weight (near 1), bias, running mean; fc.bias
            w = rng.normal(1.0 if k.endswith("bn.weight") else 0.0, 0.1, shape)
        out[k] = w.astype(np.float32)
    return out


@lru_cache(maxsize=2)
def load_model(npz_path: str, device: torch.device) -> InceptionV3:
    """Inception-v3 loaded strictly from ``npz_path``, in eval mode on
    ``device``."""
    model = InceptionV3()
    model.load_state_dict(state_from_npz(npz_path), strict=True)
    return model.eval().to(device)


def classify_with_weights(npz_path: str, images, batch_size: int = 32) -> np.ndarray:
    """images: [B, H, W, 3] (a tensor on any device, or numpy) -> softmax
    probs [B, 1000] fp32 numpy: chunks of ``batch_size`` upsampled
    bilinearly to ``INPUT_SIZE`` px, the logits, and a softmax in fp32
    (the reference's upsample-to-299 + Inception-v3 pass,
    ``train_utils.py:848-866``). The JAX loop pads its last chunk to the
    batch; eval-mode BatchNorm makes that padding inert, so here the last
    chunk runs as it is."""
    x = torch.as_tensor(images)
    model = load_model(npz_path, x.device)
    out = []
    with torch.no_grad():
        for lo in range(0, x.shape[0], batch_size):
            chunk = resize_batch(x[lo:lo + batch_size].float(), INPUT_SIZE)
            logits = model(chunk.permute(0, 3, 1, 2).contiguous())
            out.append(torch.softmax(logits.float(), dim=-1).cpu().numpy())
    return np.concatenate(out)
