"""Forward convolutions and dense layers with the reference's geometry.

NCHW activations, torch weight layouts (Conv2d OIHW, ConvTranspose2d IOHW,
Linear [out, in]). These stay cuDNN/cuBLAS calls: the JAX package leaves them
to XLA, not to Pallas. ``compute_dtype='bfloat16'`` casts both operands to
bf16 and the result back to fp32, as ``fmri_tpu/ops/conv.py:27-37`` does, so
BatchNorm and everything after it stays fp32.

No tap flip happens in :func:`conv2d_transpose`: torch's transposed conv
already scatters its kernel the way the reference's ``ConvTranspose2d`` does;
the 180-degree rotation between the JAX correlation layout and this one lives
in the weight converter (``fmri_tpu_torch.checkpoints.convert``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _operands(compute_dtype: str | None, *ts):
    if compute_dtype in (None, "float32"):
        return ts
    cd = getattr(torch, compute_dtype)
    return tuple(None if t is None else t.to(cd) for t in ts)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None,
           compute_dtype: str | None = None) -> torch.Tensor:
    """``x @ weight.T + bias``; bf16 operands (bias included, as a flax
    ``Dense(dtype=bf16)`` does) give an fp32 result."""
    x, weight, bias = _operands(compute_dtype, x, weight, bias)
    return F.linear(x, weight, bias).float()


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0, compute_dtype: str | None = None) -> torch.Tensor:
    """``nn.Conv2d(k, s, p)`` forward, no bias. x: [B, Ci, H, W];
    weight: [Co, Ci, k, k]."""
    x, weight = _operands(compute_dtype, x, weight)
    return F.conv2d(x, weight, stride=stride, padding=padding).float()


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor, stride: int = 2,
                     padding: int = 2, output_padding: int = 0,
                     compute_dtype: str | None = None) -> torch.Tensor:
    """``nn.ConvTranspose2d(k, s, p, output_padding)`` forward, no bias:
    out = (in - 1) * stride - 2 * padding + k + output_padding.
    x: [B, Ci, H, W]; weight: [Ci, Co, k, k]."""
    x, weight = _operands(compute_dtype, x, weight)
    return F.conv_transpose2d(x, weight, stride=stride, padding=padding,
                              output_padding=output_padding).float()
