"""Windowed SSIM: the hand-written CUDA kernel and its plain PyTorch version.

Same function as ``fmri_tpu/ops/pallas_ssim.py::ssim_pallas`` and
``fmri_tpu/metrics/quality.py::ssim``: Gaussian window (sigma 1.5) of
``real_size = min(window_size, H, W)`` taps, zero padding of
``window_size // 2`` (so a small image gives an output larger than itself),
C1 = 0.01^2 and C2 = 0.03^2 without the dynamic-range factor
(``train_utils.py:345-425``). Images are NHWC float32.

* :func:`ssim` is the entry: a CPU tensor goes to :func:`ssim_plain`, a CUDA
  tensor to the kernel through :func:`ssim_plane_sums` (or an error).
* :func:`ssim_plane_sums` launches ``csrc/ssim.cu`` and counts its launches
  in ``ssim_plane_sums.launches``.
* :func:`ssim_plain` is grouped ``F.conv2d`` with the 2-D window, the math of
  the reference's XLA path; the CPU tests use it and ``chip_smoke.py`` holds
  the kernel against it on the card (with TF32 off).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01**2
C2 = 0.03**2
MAX_TAPS = 16           # kMaxTaps in csrc/ssim.cu
SMEM_BUDGET = 100 * 1024  # bytes per block: two blocks fit on one SM


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """1-D Gaussian normalised to sum 1 (``pallas_ssim.py:34-40``), float64."""
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    return g / g.sum()


def geometry(h: int, w: int, window_size: int = 11):
    """(taps, pad, out_h, out_w) of the SSIM map for an h x w image."""
    k = min(window_size, h, w)
    pad = window_size // 2
    return k, pad, h + 2 * pad - (k - 1), w + 2 * pad - (k - 1)


def plan(h: int, w: int, window_size: int = 11):
    """(tile_rows, shared-memory bytes) of one kernel block: the largest
    power-of-two tile of output rows, at most 32 and at most the output
    height, whose staged rows fit ``SMEM_BUDGET``."""
    k, pad, ho, wo = geometry(h, w, window_size)
    tile = min(32, ho)
    while True:
        rows = tile + k - 1
        smem = 4 * rows * (2 * (w + 2 * pad) + 5 * wo)
        if smem <= SMEM_BUDGET:
            return tile, smem
        if tile == 1:
            raise ValueError(f"SSIM of {h}x{w} images needs {smem} bytes of "
                             f"shared memory per row tile; the kernel allows "
                             f"{SMEM_BUDGET}")
        tile //= 2


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
               size_average: bool = True) -> torch.Tensor:
    """Plain PyTorch SSIM: depthwise ``F.conv2d`` with the 2-D window."""
    b, h, w, c = img1.shape
    k, pad, _, _ = geometry(h, w, window_size)
    g = gaussian_window(k)
    win = torch.from_numpy(np.outer(g, g).astype(np.float32)).to(img1.device)
    win = win.expand(c, 1, k, k)
    x = img1.permute(0, 3, 1, 2)
    y = img2.permute(0, 3, 1, 2)

    def blur(t):
        return F.conv2d(t, win, padding=pad, groups=c)

    mu1, mu2 = blur(x), blur(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(x * x) - mu1_sq
    s2 = blur(y * y) - mu2_sq
    s12 = blur(x * y) - mu12
    score = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    if size_average:
        return score.mean()
    return score.mean(dim=(1, 2, 3))


def _check(img1: torch.Tensor, img2: torch.Tensor) -> None:
    for name, t in (("img1", img1), ("img2", img2)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, W, C], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous NHWC")
    if img1.shape != img2.shape or img1.device != img2.device:
        raise ValueError(f"img1 {tuple(img1.shape)} on {img1.device} and img2 "
                         f"{tuple(img2.shape)} on {img2.device} differ")


@functools.cache
def _kernel():
    """``ssim_plane_sums`` of the built ``csrc/ssim.cu``, typed for ctypes
    (pointers and the stream as ``c_void_p``, strides as 64-bit)."""
    from fmri_tpu_torch.ops import build

    fn = build.load("ssim").ssim_plane_sums
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 8
                   + [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    return fn


def ssim_plane_sums(img1: torch.Tensor, img2: torch.Tensor,
                    window_size: int = 11) -> torch.Tensor:
    """[B, C] float32 sums of the SSIM map of each (image, channel) plane,
    by one launch of ``csrc/ssim.cu``."""
    _check(img1, img2)
    b, h, w, c = img1.shape
    k, pad, _, _ = geometry(h, w, window_size)
    if k > MAX_TAPS:
        raise ValueError(f"window of {k} taps; the kernel takes at most {MAX_TAPS}")
    out = torch.empty((b, c), dtype=torch.float32, device=img1.device)
    if b == 0 or c == 0:
        return out
    tile, smem = plan(h, w, window_size)
    fn = _kernel()
    taps = (ctypes.c_float * k)(*gaussian_window(k))
    sb, sh, sw, sc = img1.stride()
    tb, th, tw, tc = img2.stride()
    with torch.cuda.device(img1.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(img1.data_ptr(), img2.data_ptr(), out.data_ptr(), b, c, h, w,
                sb, sh, sw, sc, tb, th, tw, tc, k, pad, taps, tile, smem, stream)
    if rc != 0:
        raise RuntimeError(f"ssim kernel launch failed with CUDA error {rc} "
                           f"(shape {tuple(img1.shape)}, {smem} B shared memory)")
    ssim_plane_sums.launches += 1
    return out


ssim_plane_sums.launches = 0


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Windowed SSIM of NHWC float32 images: the mean over everything
    (``size_average=True``) or per image ([B]). CUDA tensors run the kernel;
    CPU tensors run :func:`ssim_plain`."""
    if img1.device.type == "cpu":
        return ssim_plain(img1, img2, window_size, size_average)
    b, h, w, c = img1.shape
    _, _, ho, wo = geometry(h, w, window_size)
    sums = ssim_plane_sums(img1, img2, window_size).double()
    if size_average:
        return (sums.sum() / (b * c * ho * wo)).float()
    return (sums.sum(dim=1) / (c * ho * wo)).float()
