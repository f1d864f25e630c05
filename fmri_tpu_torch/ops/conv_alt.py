"""Algebraic rewrites of two conv-backward ops, behind
``ModelConfig.alt_backward``: the port's copy of ``fmri_tpu/ops/conv_alt.py``.

* :func:`conv2d_dw_patches`: the weight grad of a stride-1 conv with few
  output channels (the decoder's 64->3 image head) as 25 tap slices of the
  padded cotangent and one tall matmul.
* :func:`conv2d_dx_phases`: the input grad of a k5/p2/s2 conv as four
  stride-1 convolutions, one per output parity (py, px), each with a
  flipped 2x2-strided sub-kernel, then interleaved.

Both are plain PyTorch (cuDNN ``F.conv2d`` per phase, ``torch.matmul`` for
the patches): the JAX package writes them as XLA code, not as Pallas
kernels. Layouts are the port's, NCHW activations and OIHW weights, so the
slices, flips and transposes are derived here for that layout rather than
copied from the NHWC/HWIO originals.

With a bf16 compute dtype the phases convolve bf16 operands and round each
result to bf16 before widening to fp32 (``conv_alt.py:107``), while the
patches matmul accumulates in fp32 (``preferred_element_type``), as the JAX
functions do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_dw_patches(x: torch.Tensor, dy: torch.Tensor, padding: int,
                      k: int = 5) -> torch.Tensor:
    """Weight grad of ``conv2d(x, w, stride=1, padding)`` as one matmul.

    x: [B, Ci, H, W]; dy: [B, Co, OH, OW] with OH = H + 2 * padding - k + 1.
    Returns [Co, Ci, k, k] in fp32.

    dW[co, ci, kh, kw] = sum_{n, y, x} xp[n, ci, y + kh, x + kw] dy[n, co, y, x]
    over the padded input xp. On the padded grid a = y + kh, dy[y] =
    dyp[a - kh + k - 1] with dyp = dy padded by k - 1, so tap (kh, kw) is
    the [Hp, Wp] slice of dyp starting at (k - 1 - kh, k - 1 - kw), and the
    whole grad is [Ci, B*Hp*Wp] @ [B*Hp*Wp, Co*k*k].
    """
    b, ci, h, w = x.shape
    co, oh, ow = dy.shape[1:]
    hp, wp = h + 2 * padding, w + 2 * padding
    if (oh, ow) != (hp - k + 1, wp - k + 1):
        raise ValueError(f"conv2d_dw_patches: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} do not match k={k}, padding={padding}")
    xp = F.pad(x, (padding,) * 4)
    dyp = F.pad(dy, (k - 1,) * 4)
    taps = torch.stack([dyp[:, :, k - 1 - kh:k - 1 - kh + hp, k - 1 - kw:k - 1 - kw + wp]
                        for kh in range(k) for kw in range(k)], dim=2)  # [B, Co, T, Hp, Wp]
    a = xp.transpose(0, 1).reshape(ci, -1)
    d = taps.permute(1, 2, 0, 3, 4).reshape(co * k * k, -1)
    # fp32 accumulation whatever the operands: bf16 products are exact in fp32
    out = torch.matmul(a.float(), d.float().t())  # [Ci, Co*k*k]
    return out.reshape(ci, co, k, k).transpose(0, 1).contiguous()


def conv2d_dx_phases(dy: torch.Tensor, weight: torch.Tensor,
                     x_hw: tuple[int, int], padding: int = 2) -> torch.Tensor:
    """Input grad of ``conv2d(x, weight, stride=2, padding=2)``, k = 5, by
    subpixel phases.

    dy: [B, Co, OH, OW]; weight: [Co, Ci, 5, 5]; x_hw: the even (H, W) of
    the input pulled back to (OH = H / 2). Returns [B, Ci, H, W] in fp32.

    Row 2u + py of dX receives the taps kh = py + 2i with oy = u + 1 - i:
    dX[n, ci, 2u+py, 2v+px] = sum_{co, i, j} dy[n, co, u+1-i, v+1-j]
    * W[co, ci, py+2i, px+2j]. As a cross-correlation that is the flipped
    sub-kernel W[:, :, py::2, px::2], transposed to [Ci, Co, nh, nw], over
    dy padded by nh - 2 before and 1 after (and likewise in width).
    """
    if padding != 2 or weight.shape[-1] != 5:
        raise ValueError(f"conv2d_dx_phases: needs k=5, padding=2; got "
                         f"k={weight.shape[-1]}, padding={padding}")
    h, w = x_hw
    b, ci = dy.shape[0], weight.shape[1]
    if h % 2 or w % 2 or dy.shape[2:] != (h // 2, w // 2):
        raise ValueError(f"conv2d_dx_phases: dy {tuple(dy.shape)} is not the "
                         f"stride-2 grad of an even {h}x{w} input")
    phases = []
    for py in range(2):
        for px in range(2):
            sub = weight[:, :, py::2, px::2].flip(2, 3).transpose(0, 1)  # [Ci, Co, nh, nw]
            nh, nw = sub.shape[2:]
            phases.append(F.conv2d(F.pad(dy, (nw - 2, 1, nh - 2, 1)), sub))
    # [py, px, B, Ci, H/2, W/2] -> [B, Ci, H/2, py, W/2, px] -> [B, Ci, H, W]
    out = torch.stack(phases).view(2, 2, b, ci, h // 2, w // 2)
    return out.permute(2, 3, 4, 0, 5, 1).reshape(b, ci, h, w).float()
