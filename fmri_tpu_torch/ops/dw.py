"""Convolution weight gradients through the hand-written CUDA kernel
``csrc/dw.cu``, or their plain PyTorch versions.

Counterpart of ``fmri_tpu/ops/pallas_dw.py``: ``_tap_matmul`` (:71) and the
two geometries that use it, ``conv2d_dw`` (:132) and ``conv2d_transpose_dw``
(:173). Each sums ``X_tap^T @ dY`` over batch and pixels for every kernel
tap, in fp32, and returns the weight grad **in the port's layout**:

* :func:`conv2d_dw` -> Conv2d OIHW ``[Co, Ci, k, k]``;
* :func:`conv2d_transpose_dw` -> ConvTranspose2d IOHW ``[Ci, Co, k, k]`` in
  torch's scatter convention (the JAX layout's 180-degree tap rotation lives
  only in ``checkpoints/convert.py``).

Activations are NCHW. Operands are fp32 or bf16 (the caller casts both to
the compute dtype); the result is fp32. A CUDA tensor launches
:func:`tap_matmul` (one kernel, counted in ``tap_matmul.launches``) or
raises; a CPU tensor takes ``*_plain``, one einsum per tap
(:func:`tap_matmul_plain`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
RK = 32               # reduction rows staged per step (csrc/dw.cu)
TILES = ((64, 64), (64, 32), (256, 4))  # TM x TN of tile ids 0, 1, 2
TARGET_BLOCKS = 528   # 4 blocks of 256 threads per SM on 132 SMs
MIN_ROWS = 1024       # reduction rows per split, at least


def _out_size(n: int, k: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - k) // stride + 1


def tap_matmul_plain(shifted: torch.Tensor, direct: torch.Tensor, k: int,
                     stride: int, pad: int) -> torch.Tensor:
    """:func:`tap_matmul` as one einsum per tap over the zero-padded
    ``shifted`` operand, in fp32."""
    _, _, hs, ws = shifted.shape
    _, _, ph, pw = direct.shape
    hi_h = max(0, (ph - 1) * stride + k - pad - hs)
    hi_w = max(0, (pw - 1) * stride + k - pad - ws)
    sp = F.pad(shifted.float(), (pad, hi_w, pad, hi_h))
    df = direct.float()
    taps = [torch.einsum("bshw,buhw->us",
                         sp[:, :, kh:kh + stride * (ph - 1) + 1:stride,
                            kw:kw + stride * (pw - 1) + 1:stride], df)
            for kh in range(k) for kw in range(k)]
    return torch.stack(taps, -1).view(direct.shape[1], shifted.shape[1], k, k)


def conv2d_dw_plain(x: torch.Tensor, dy: torch.Tensor, stride: int,
                    padding: int, k: int = 5) -> torch.Tensor:
    """OIHW fp32 weight grad of ``F.conv2d(x, w, stride, padding)``:
    dW[co, ci, kh, kw] = sum x[b, ci, oh*s - p + kh, ow*s - p + kw] * dy[b, co, oh, ow]."""
    return tap_matmul_plain(x, dy, k, stride, padding)


def conv2d_transpose_dw_plain(x: torch.Tensor, dy: torch.Tensor, stride: int = 2,
                              padding: int = 2, output_padding: int = 0,
                              k: int = 5) -> torch.Tensor:
    """IOHW fp32 weight grad of ``F.conv_transpose2d(x, w, stride, padding,
    output_padding)``: dW[ci, co, kh, kw] = sum x[b, ci, i, j] *
    dy[b, co, i*s - p + kh, j*s - p + kw] over the indices inside dy
    (``output_padding`` is implied by dy's shape)."""
    del output_padding
    return tap_matmul_plain(dy, x, k, stride, padding)


def _check(shifted: torch.Tensor, direct: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a consistent operand pair; raises otherwise."""
    for name, t in (("shifted", shifted), ("direct", direct)):
        if t.dim() != 4:
            raise ValueError(f"{name} operand must be NCHW, got {tuple(t.shape)}")
    if shifted.device != direct.device:
        raise ValueError(f"operands on {shifted.device} and {direct.device}")
    if shifted.shape[0] != direct.shape[0]:
        raise ValueError(f"batch {shifted.shape[0]} vs {direct.shape[0]}")
    kind = shifted.device.type
    if kind == "cpu":
        return kind
    if kind != "cuda":
        raise ValueError(f"unsupported device {shifted.device}")
    if shifted.dtype not in KERNEL_DTYPES or direct.dtype != shifted.dtype:
        raise TypeError(f"operands must both be float32 or bfloat16, got "
                        f"{shifted.dtype} and {direct.dtype}")
    if not (shifted.is_contiguous() and direct.is_contiguous()):
        raise ValueError("operands must be contiguous NCHW")
    if max(shifted.numel(), direct.numel()) >= 2**31:
        raise ValueError("operands of 2**31 elements or more")
    return kind


@functools.cache
def _lib():
    """The built ``csrc/dw.cu``, typed for ctypes."""
    from fmri_tpu_torch.ops import build

    lib = build.load("dw")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tap_matmul.restype = i
    lib.tap_matmul.argtypes = [p] * 4 + [i] * 14 + [p]
    return lib


def plan(m: int, n: int, r: int) -> tuple[int, int, int]:
    """(tile id, splits, reduction rows per split) for D = [n, m] summed over
    r rows: the narrowest tile that covers n, and enough splits of r to fill
    the card with blocks of at least ``MIN_ROWS`` rows."""
    def cdiv(a, b):
        return -(-a // b)

    tile = 2 if n <= 4 else 1 if n <= 32 else 0
    tm, tn = TILES[tile]
    splits = max(1, min(cdiv(TARGET_BLOCKS, cdiv(m, tm) * cdiv(n, tn)),
                        cdiv(r, MIN_ROWS)))
    chunk = cdiv(cdiv(r, splits), RK) * RK
    return tile, cdiv(r, chunk), chunk


def tap_matmul(shifted: torch.Tensor, direct: torch.Tensor, k: int, stride: int,
               pad: int) -> torch.Tensor:
    """``out[cu, cs, kh, kw] = sum_{b,ph,pw} shifted[b, cs, ph*stride - pad + kh,
    pw*stride - pad + kw] * direct[b, cu, ph, pw]`` (zero outside
    ``shifted``), fp32 ``[Cu, Cs, k, k]``, by one launch of ``csrc/dw.cu``.
    CUDA tensors only."""
    if _check(shifted, direct) != "cuda":
        raise ValueError("tap_matmul runs on CUDA tensors; CPU callers use "
                         "conv2d_dw / conv2d_transpose_dw")
    b, cs, hs, ws = shifted.shape
    _, cu, ph, pw = direct.shape
    m, r = cs * k * k, b * ph * pw
    out = torch.empty((cu, cs, k, k), dtype=torch.float32, device=shifted.device)
    if out.numel() == 0 or r == 0:
        return out.zero_()
    tile, splits, chunk = plan(m, cu, r)
    partial = (torch.empty((splits, cu, m), dtype=torch.float32,
                           device=shifted.device) if splits > 1 else out)
    with torch.cuda.device(shifted.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().tap_matmul(shifted.data_ptr(), direct.data_ptr(),
                               partial.data_ptr(), out.data_ptr(),
                               KERNEL_DTYPES[shifted.dtype], tile, b, cs, hs, ws,
                               cu, ph, pw, k, stride, pad, splits, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"tap_matmul launch failed with CUDA error {rc} "
                           f"(shifted {tuple(shifted.shape)}, direct "
                           f"{tuple(direct.shape)}, k {k}, stride {stride})")
    tap_matmul.launches += 1
    return out


tap_matmul.launches = 0


def conv2d_dw(x: torch.Tensor, dy: torch.Tensor, stride: int, padding: int,
              k: int = 5) -> torch.Tensor:
    """OIHW fp32 weight grad of ``conv2d(x, w, stride, padding)``."""
    oh, ow = _out_size(x.shape[2], k, stride, padding), _out_size(x.shape[3], k, stride, padding)
    if tuple(dy.shape[2:]) != (oh, ow):
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x.shape)} at k {k}, stride {stride}, padding {padding}")
    if _check(x, dy) == "cpu":
        return conv2d_dw_plain(x, dy, stride, padding, k)
    return tap_matmul(x, dy, k, stride, padding)


def conv2d_transpose_dw(x: torch.Tensor, dy: torch.Tensor, stride: int = 2,
                        padding: int = 2, output_padding: int = 0,
                        k: int = 5) -> torch.Tensor:
    """IOHW fp32 weight grad of ``conv2d_transpose(x, w, stride, padding,
    output_padding)``."""
    want = tuple((n - 1) * stride - 2 * padding + k + output_padding
                 for n in x.shape[2:])
    if tuple(dy.shape[2:]) != want:
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x.shape)} at k {k}, stride {stride}, padding "
                         f"{padding}, output_padding {output_padding}")
    if _check(dy, x) == "cpu":
        return conv2d_transpose_dw_plain(x, dy, stride, padding, output_padding, k)
    return tap_matmul(dy, x, k, stride, padding)
