"""The port's convolution weight gradients (``fmri_tpu_torch/ops/dw.py``) and
their autograd wiring (``fmri_tpu_torch/ops/conv.py``) against the JAX
package's Pallas tap-matmul kernels (``fmri_tpu/ops/pallas_dw.py``, run in
interpret mode on the CPU as its own tests run them) and torch's autograd.

The JAX kernels return [k, k, Ci, Co] in the JAX layout; the port returns
its own weight layout (Conv2d OIHW, ConvTranspose2d IOHW in torch's scatter
convention), so the JAX result goes through the port's converter
(``_inv_conv``, ``_inv_deconv``, which rotates deconv taps 180 degrees)
before the comparison. The geometries are those of
``tests/test_pallas_dw.py:35-80``.

Tolerances: fp32 sums over up to 2,000 products in other orders, rtol 2e-5
and atol 2e-4 (as ``tests/test_pallas_dw.py``); bf16 operands: both sides
multiply exactly in fp32 and sum in fp32, the same bound. dx goes through
the stock input grad and is bit-identical to autograd's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fmri_tpu.ops import pallas_dw
from fmri_tpu_torch.checkpoints.convert import _inv_conv, _inv_deconv
from fmri_tpu_torch.ops import conv, dw


def _nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


def _pair(x_shape, dy_shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=x_shape).astype(np.float32),
            rng.normal(size=dy_shape).astype(np.float32))


CONV = [(2, 8, 3, 4, 1), (3, 8, 64, 3, 1), (2, 8, 3, 4, 2), (3, 16, 64, 5, 2),
        (2, 10, 4, 6, 2)]
DECONV = [(2, 4, 4, 3, 1), (2, 5, 3, 4, 1), (2, 4, 4, 3, 0), (3, 4, 64, 5, 1)]


@pytest.mark.parametrize("b,h,ci,co,stride,dtype",
                         [(*c, "float32") for c in CONV]
                         + [(*c, "bfloat16") for c in CONV[2:4]])
def test_conv2d_dw_plain_matches_pallas(b, h, ci, co, stride, dtype):
    oh = (h + 4 - 5) // stride + 1
    x, dy = _pair((b, ci, h, h), (b, co, oh, oh), seed=b * h + ci + co)
    jd = jnp.dtype(dtype)
    ref = pallas_dw.conv2d_dw(jnp.asarray(_nhwc(x), jd), jnp.asarray(_nhwc(dy), jd),
                              stride=stride, padding=2)
    td = getattr(torch, dtype)
    got = dw.conv2d_dw(torch.from_numpy(x).to(td), torch.from_numpy(dy).to(td),
                       stride, 2, 5)
    assert got.dtype == torch.float32 and got.shape == (co, ci, 5, 5)
    np.testing.assert_allclose(got.numpy(), _inv_conv(np.asarray(ref)), rtol=2e-5,
                               atol=2e-4)


@pytest.mark.parametrize("b,h,ci,co,output_padding,dtype",
                         [(*c, "float32") for c in DECONV]
                         + [(*c, "bfloat16") for c in DECONV[::3]])
def test_conv2d_transpose_dw_plain_matches_pallas(b, h, ci, co, output_padding, dtype):
    oh = (h - 1) * 2 - 4 + 5 + output_padding
    x, dy = _pair((b, ci, h, h), (b, co, oh, oh), seed=b * h + ci + co + output_padding)
    jd = jnp.dtype(dtype)
    ref = pallas_dw.conv2d_transpose_dw(
        jnp.asarray(_nhwc(x), jd), jnp.asarray(_nhwc(dy), jd), stride=2, padding=2,
        output_padding=output_padding)
    td = getattr(torch, dtype)
    got = dw.conv2d_transpose_dw(torch.from_numpy(x).to(td),
                                 torch.from_numpy(dy).to(td), 2, 2, output_padding, 5)
    assert got.dtype == torch.float32 and got.shape == (ci, co, 5, 5)
    np.testing.assert_allclose(got.numpy(), _inv_deconv(np.asarray(ref)), rtol=2e-5,
                               atol=2e-4)


def _grads(fn, x, w, dy):
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    y = fn(x, w)
    return (y, *torch.autograd.grad(y, (x, w), dy))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("kind,stride,output_padding", [
    ("conv", 1, 0), ("conv", 2, 0), ("deconv", 2, 1), ("deconv", 2, 0)])
def test_functions_match_torch_autograd(kind, stride, output_padding, compute_dtype):
    """(y, dx, dW) of conv2d/conv2d_transpose with ``pallas_backward``
    against torch autograd of the same forward. y and dx are the stock ops
    (bit-identical); dW: fp32 within rtol 2e-5/atol 2e-4; bf16 against
    autograd on the bf16-rounded operands in float64 (exact products, so
    only fp32 summation differs), since stock autograd rounds its bf16 dW
    to bf16 where the kernel keeps fp32, as the JAX kernel does."""
    rng = np.random.default_rng(stride + output_padding)
    if kind == "conv":
        x = torch.from_numpy(rng.normal(size=(2, 6, 8, 8)).astype(np.float32))
        w = torch.from_numpy(0.1 * rng.normal(size=(4, 6, 5, 5)).astype(np.float32))
        fwd = lambda xx, ww, pb: conv.conv2d(xx, ww, stride, 2, compute_dtype, pb)  # noqa: E731
        ref_fn = lambda xx, ww: F.conv2d(xx, ww, stride=stride, padding=2)  # noqa: E731
    else:
        x = torch.from_numpy(rng.normal(size=(2, 6, 4, 4)).astype(np.float32))
        w = torch.from_numpy(0.1 * rng.normal(size=(6, 4, 5, 5)).astype(np.float32))
        fwd = lambda xx, ww, pb: conv.conv2d_transpose(  # noqa: E731
            xx, ww, 2, 2, output_padding, compute_dtype, pb)
        ref_fn = lambda xx, ww: F.conv_transpose2d(  # noqa: E731
            xx, ww, stride=2, padding=2, output_padding=output_padding)
    shape = tuple(fwd(x, w, False).shape)
    dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    y_ref, dx_ref, dw_ref = _grads(lambda a, b: fwd(a, b, False), x, w, dy)
    y, dx, dw_ = _grads(lambda a, b: fwd(a, b, True), x, w, dy)
    assert torch.equal(y, y_ref) and torch.equal(dx, dx_ref)
    if compute_dtype is None:
        np.testing.assert_allclose(dw_.numpy(), dw_ref.numpy(), rtol=2e-5, atol=2e-4)
    else:
        exact = _grads(ref_fn, x.bfloat16().double(), w.bfloat16().double(),
                       dy.bfloat16().double())[2]
        np.testing.assert_allclose(dw_.numpy(), exact.numpy(), rtol=2e-5, atol=2e-4)


class _Casts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the dtype casts (``aten._to_copy`` to another dtype) that run
    under it, by (shape, source dtype, target dtype); autograd's worker runs
    the backward under the same mode."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.aten._to_copy.default and out.dtype != args[0].dtype:
            key = (tuple(args[0].shape), args[0].dtype, out.dtype)
            self.n[key] = self.n.get(key, 0) + 1
        return out


@pytest.mark.parametrize("kind", ["conv", "deconv"])
def test_bf16_weight_grad_node_casts_each_operand_once(kind):
    """A bf16 ``pallas_backward`` conv or deconv casts x to bf16 once, for
    its forward, its input grad and its weight grad together, and dy once,
    for both grads; dx and dW are the bits of the arithmetic they replace:
    dx the stock autograd of the bf16 forward, dW ``ops/dw.py`` on the
    operands cast to bf16."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 6, 8, 8)).astype(np.float32))
    if kind == "conv":
        w = torch.from_numpy(0.1 * rng.normal(size=(4, 6, 5, 5)).astype(np.float32))
        fwd = lambda a, b, pb: conv.conv2d(a, b, 2, 2, "bfloat16", pb)  # noqa: E731
    else:
        w = torch.from_numpy(0.1 * rng.normal(size=(6, 4, 5, 5)).astype(np.float32))
        fwd = lambda a, b, pb: conv.conv2d_transpose(a, b, 2, 2, 1, "bfloat16", pb)  # noqa: E731
    dy = torch.from_numpy(rng.normal(size=tuple(fwd(x, w, False).shape)).astype(np.float32))
    casts = _Casts()
    with casts:
        y, dx, dw_ = _grads(lambda a, b: fwd(a, b, True), x, w, dy)
    y_ref, dx_ref, _ = _grads(lambda a, b: fwd(a, b, False), x, w, dy)
    xb, dyb = x.bfloat16(), dy.bfloat16()
    dw_ref = (dw.conv2d_dw(xb, dyb, 2, 2, 5) if kind == "conv"
              else dw.conv2d_transpose_dw(xb, dyb, 2, 2, 1, 5))
    assert torch.equal(y, y_ref) and torch.equal(dx, dx_ref) and torch.equal(dw_, dw_ref)
    to_bf16 = (torch.float32, torch.bfloat16)
    assert casts.n[(tuple(x.shape), *to_bf16)] == 1
    assert casts.n[(tuple(dy.shape), *to_bf16)] == 1


def test_out_of_scope_geometry_takes_the_stock_backward():
    """k3/p1/s2 is outside the kernel's gate (as in the JAX package): no
    custom Function, and the gradients are autograd's own."""
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    w = torch.randn(5, 4, 3, 3, requires_grad=True)
    y = conv.conv2d(x, w, 2, 1, None, pallas_backward=True)
    assert "DW" not in type(y.grad_fn).__name__
    ref = F.conv2d(x, w, stride=2, padding=1)
    dy = torch.randn_like(ref)
    for g, r in zip(torch.autograd.grad(y, (x, w), dy), torch.autograd.grad(ref, (x, w), dy)):
        assert torch.equal(g, r)
    y = conv.conv2d(x, w[..., :1, :1].contiguous(), 1, 0, None, pallas_backward=True)
    assert "Conv2dDW" in type(y.grad_fn).__name__  # stride 1: any k/p
    w5 = torch.randn(4, 3, 5, 5, requires_grad=True)
    y = conv.conv2d_transpose(x, w5, 2, 1, 1, None, pallas_backward=True)
    assert "DW" not in type(y.grad_fn).__name__  # deconv: k5/p2/s2 only


def _pitch_rows(a, row_pitch):
    """``csrc/dw.cu::dw_pitch_rows``: the rows (last axis) of ``a`` on
    ``row_pitch`` elements, flat. The kernel writes zeros past each row;
    here they are NaN, so a tensor map whose true extents let one through
    spoils the result."""
    rows = a.reshape(-1, a.shape[-1])
    out = np.full((rows.shape[0], row_pitch), np.nan)
    out[:, :rows.shape[1]] = rows
    return out.reshape(-1)


def _tma_box(flat, dims, row_pitch, start, box):
    """A TMA box of a tensor map over ``flat``: extents ``dims`` and box
    ``box`` innermost first, rows ``row_pitch`` elements apart, the box at
    ``start``; zero outside the extents. Returned outermost first."""
    strides = np.cumprod([1, row_pitch, *dims[1:-1]])
    grids = np.meshgrid(*[np.arange(c, c + n) for c, n in zip(start, box)][::-1],
                        indexing="ij")[::-1]
    inside = np.logical_and.reduce([(g >= 0) & (g < d) for g, d in zip(grids, dims)])
    offset = sum(g * st for g, st in zip(grids, strides))
    return np.where(inside, flat[np.where(inside, offset, 0)], 0.0)


def _emulate_kernel(shifted, direct, k, stride, pad, esz=4):
    """csrc/dw.cu's indexing in numpy (float64): the wrapper's plan (mt, nt,
    splits, chunk, the S patch [Cp, Hp, Wp] and the row pitches); both
    operands on their pitched rows as TMA reads them (``_pitch_rows``, the
    staged copy, wherever the pitch is not the row); the reduction in tiles
    of RK positions of one image, the U box [nt, RK] at (pos0, n0, b) and
    the S patch box at (w0, h0, cs_lo, b), zero outside the true extents
    (``_tma_box``); each thread's row offset (channel, kh, kw; rows past M
    clamped to the last) and each position's offset (ph, pw) into the
    patch; one partial per split, and the second pass's sum over splits in
    split order."""
    b, cs, hs, ws = shifted.shape
    _, cu, ph_n, pw_n = direct.shape
    m_n, phw, rk = cs * k * k, ph_n * pw_n, dw.ROW_BYTES // esz
    per_image, unit = -(-phw // rk), 16 // esz
    p = dw.plan(shifted.shape, direct.shape, k, stride, esz)
    assert (p.s_pitch * esz) % 16 == 0 and (p.u_pitch * esz) % 16 == 0
    s_flat = _pitch_rows(shifted, p.s_pitch)
    u_flat = _pitch_rows(direct.reshape(b, cu, phw), p.u_pitch)
    partial = np.zeros((p.splits, cu, m_n))
    for m0 in range(0, m_n, p.mt):
        cs_lo = m0 // (k * k)
        m = np.minimum(np.arange(m0, m0 + p.mt), m_n - 1)
        c, tap = m // (k * k) - cs_lo, m % (k * k)
        mb = (c * p.hp + tap // k) * p.wp + tap % k
        rows = slice(m0, min(m0 + p.mt, m_n))
        for z in range(p.splits):
            for tile in range(z * p.chunk, min(b * per_image, (z + 1) * p.chunk)):
                bb, pos0 = tile // per_image, (tile % per_image) * rk
                ph0 = pos0 // pw_n
                pw0 = pos0 - ph0 * pw_n if p.within_row else 0
                h0 = ph0 * stride - pad
                w0 = (pw0 * stride - pad) // unit * unit  # 16-byte start
                shift = pw0 * stride - pad - w0
                patch = _tma_box(s_flat, (ws, hs, cs, b), p.s_pitch, (w0, h0, cs_lo, bb),
                                 (p.wp, p.hp, p.cp, 1)).reshape(-1)
                pos = pos0 + np.arange(rk)
                ph = pos // pw_n
                ro = shift + np.where(pos < phw, (ph - ph0) * stride * p.wp
                                      + (pos - ph * pw_n - pw0) * stride, 0)
                a = patch[ro[:, None] + mb[None]]                      # [rk, mt]
                for n0 in range(0, cu, p.nt):
                    u = _tma_box(u_flat, (phw, cu, b), p.u_pitch, (pos0, n0, bb),
                                 (rk, p.nt, 1))[0]                     # [nt, rk]
                    cols = slice(n0, min(n0 + p.nt, cu))
                    partial[z][cols, rows] += (u @ a)[:cols.stop - n0, :rows.stop - m0]
    out = partial[0]
    for z in range(1, p.splits):
        out = out + partial[z]
    return out.reshape(cu, cs, k, k)


@pytest.mark.parametrize("kind,b,ci,h,co,stride", [
    ("conv", 4, 3, 64, 32, 1), ("conv", 2, 16, 16, 8, 2), ("conv", 2, 8, 8, 3, 1),
    ("deconv", 2, 16, 8, 8, 2), ("deconv", 2, 4, 5, 3, 2), ("conv", 3, 5, 9, 7, 2),
    ("conv", 2, 8, 64, 4, 2), ("conv", 2, 4, 32, 130, 1),
    # res100's geometries (50 -> 25, 25 -> 13, 13 -> 7 px; the decoder's 13
    # and 25 px inputs; the out conv's 100 px rows), whose rows are not whole
    # 16-byte units and are staged on pitched rows, at small batch and width
    *[(f"{kind}-{dtype}", 2, ci, h, co, stride) for dtype in ("fp32", "bf16")
      for kind, ci, h, co, stride in (
          ("conv", 3, 50, 4, 2), ("conv", 4, 25, 5, 2), ("conv", 6, 13, 9, 2),
          ("deconv", 5, 13, 4, 2), ("deconv", 3, 25, 6, 2), ("conv", 3, 100, 3, 1))]])
def test_kernel_index_arithmetic_emulated(kind, b, ci, h, co, stride):
    """The CUDA kernel cannot run here; its indexing, padding, staging and
    split plan, emulated in float64, give the plain weight grad (which sums
    in fp32: rtol 1e-5, atol 1e-4). ``conv`` cases run with fp32 tiles (32
    positions), ``deconv`` ones with bf16 tiles (64), unless the kind names
    its dtype."""
    kind, _, dtype = kind.partition("-")
    esz = {"fp32": 4, "bf16": 2}.get(dtype, 4 if kind == "conv" else 2)
    rng = np.random.default_rng(b + ci + h + co)
    x = rng.normal(size=(b, ci, h, h))
    if kind == "conv":
        oh = (h + 4 - 5) // stride + 1
        dy = rng.normal(size=(b, co, oh, oh))
        ref = dw.conv2d_dw_plain(torch.from_numpy(x).double(),
                                 torch.from_numpy(dy).double(), stride, 2, 5)
        got = _emulate_kernel(x, dy, 5, stride, 2, esz)
    else:
        oh = 2 * h
        dy = rng.normal(size=(b, co, oh, oh))
        ref = dw.conv2d_transpose_dw_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                           2, 2, 1, 5)
        got = _emulate_kernel(dy, x, 5, 2, 2, esz)
    np.testing.assert_allclose(got, ref.double().numpy(), rtol=1e-5, atol=1e-4)


# (S, U, stride) of the 11 distinct fp32 calls of the res64 step, and edges
STEP_CALLS = [((64, 3, 64, 64), (64, 64, 32, 32), 2), ((64, 64, 32, 32), (64, 128, 16, 16), 2),
              ((64, 128, 16, 16), (64, 256, 8, 8), 2), ((64, 256, 16, 16), (64, 256, 8, 8), 2),
              ((64, 128, 32, 32), (64, 256, 16, 16), 2), ((64, 32, 64, 64), (64, 128, 32, 32), 2),
              ((64, 32, 64, 64), (64, 3, 64, 64), 1), ((192, 3, 64, 64), (192, 32, 64, 64), 1),
              ((192, 32, 64, 64), (192, 128, 32, 32), 2),
              ((192, 128, 32, 32), (192, 256, 16, 16), 2),
              ((192, 256, 16, 16), (192, 256, 8, 8), 2), ((1, 1, 4, 4), (1, 1, 4, 4), 1),
              ((3, 7, 9, 9), (3, 7, 5, 5), 2)]
# the 11 distinct calls of the res100 step (batch 100; discriminator 300)
RES100_CALLS = [((100, 3, 100, 100), (100, 64, 50, 50), 2),
                ((100, 64, 50, 50), (100, 128, 25, 25), 2),
                ((100, 128, 25, 25), (100, 256, 13, 13), 2),
                ((100, 256, 25, 25), (100, 256, 13, 13), 2),
                ((100, 128, 50, 50), (100, 256, 25, 25), 2),
                ((100, 64, 100, 100), (100, 128, 50, 50), 2),
                ((100, 64, 100, 100), (100, 3, 100, 100), 1),
                ((300, 3, 100, 100), (300, 32, 50, 50), 2),
                ((300, 32, 50, 50), (300, 128, 25, 25), 2),
                ((300, 128, 25, 25), (300, 256, 13, 13), 2),
                ((300, 256, 13, 13), (300, 256, 7, 7), 2)]
# Every weight grad the presets' steps call (the VAE/GAN and WAE train
# paths, the VoxelDecoder and WaeDecoder backbones), per row of the batch:
# (S [C, H, W], U [C, H, W], stride, images per row: the discriminator sees
# 3). fullbrain's convs are res64's. test_preset_calls_are_the_steps_own
# holds this table to the steps.
PRESET_CALLS = {
    16: [((3, 16, 16), (8, 8, 8), 2, 1), ((8, 8, 8), (16, 4, 4), 2, 1),
         ((8, 16, 16), (3, 16, 16), 1, 1), ((16, 4, 4), (16, 2, 2), 2, 1),
         ((128, 16, 16), (3, 16, 16), 1, 1), ((3, 16, 16), (8, 16, 16), 1, 3),
         ((8, 16, 16), (16, 8, 8), 2, 3), ((16, 4, 4), (16, 2, 2), 2, 3),
         ((16, 8, 8), (16, 4, 4), 2, 3), ((8, 16, 16), (8, 8, 8), 2, 1),
         ((16, 4, 4), (16, 2, 2), 2, 1), ((8, 8, 8), (16, 4, 4), 2, 1),
         ((128, 16, 16), (256, 8, 8), 2, 1), ((256, 8, 8), (512, 4, 4), 2, 1),
         ((512, 4, 4), (1024, 2, 2), 2, 1)],
    64: [((3, 64, 64), (64, 32, 32), 2, 1), ((64, 32, 32), (128, 16, 16), 2, 1),
         ((64, 64, 64), (3, 64, 64), 1, 1), ((128, 16, 16), (256, 8, 8), 2, 1),
         ((128, 64, 64), (3, 64, 64), 1, 1), ((3, 64, 64), (32, 64, 64), 1, 3),
         ((32, 64, 64), (128, 32, 32), 2, 3), ((128, 32, 32), (256, 16, 16), 2, 3),
         ((256, 16, 16), (256, 8, 8), 2, 3), ((64, 64, 64), (128, 32, 32), 2, 1),
         ((256, 16, 16), (256, 8, 8), 2, 1), ((128, 32, 32), (256, 16, 16), 2, 1),
         ((128, 64, 64), (256, 32, 32), 2, 1), ((256, 32, 32), (512, 16, 16), 2, 1),
         ((512, 16, 16), (1024, 8, 8), 2, 1)],
    100: [((3, 100, 100), (64, 50, 50), 2, 1), ((64, 50, 50), (128, 25, 25), 2, 1),
          ((64, 100, 100), (3, 100, 100), 1, 1), ((128, 25, 25), (256, 13, 13), 2, 1),
          ((128, 100, 100), (3, 100, 100), 1, 1), ((3, 100, 100), (32, 50, 50), 2, 3),
          ((32, 50, 50), (128, 25, 25), 2, 3), ((128, 25, 25), (256, 13, 13), 2, 3),
          ((256, 13, 13), (256, 7, 7), 2, 3), ((64, 100, 100), (128, 50, 50), 2, 1),
          ((256, 25, 25), (256, 13, 13), 2, 1), ((128, 50, 50), (256, 25, 25), 2, 1),
          ((128, 100, 100), (256, 50, 50), 2, 1), ((256, 50, 50), (512, 25, 25), 2, 1),
          ((512, 25, 25), (1024, 13, 13), 2, 1)],
}
PRESET_SIZES = {"tiny": 16, "res64": 64, "res100": 100, "fullbrain": 64}
PRESET_BATCHES = (4, 64, 100, 256, 1024)  # the suite's, the step's and the tests' batches


def _m_n_tiles(s_shape, u_shape, esz=4):
    """(m, n, reduction tiles) of a call with ``esz``-byte operands."""
    return (s_shape[1] * 25, u_shape[1],
            s_shape[0] * -(-(u_shape[2] * u_shape[3]) // (dw.ROW_BYTES // esz)))


def _patch_holds_every_tap(stride, pw, esz, hp, wp, within_row, k=5):
    """Every (tap, position) pair of every tile of one image reads inside
    its stage's S patch: kh plus the position's row offset below Hp, kw plus
    its column offset (from the patch's 16-byte-aligned first column) below
    Wp, so a TMA box of [Cp, Hp, Wp] is enough; Wp a whole number of
    16-byte units and no side over 256, TMA's limit for a box."""
    rk, unit = dw.ROW_BYTES // esz, 16 // esz
    assert (wp * esz) % 16 == 0 and max(hp, wp) <= 256
    phw = pw * pw
    for pos0 in range(0, phw, rk):
        ph0 = pos0 // pw
        pw0 = pos0 - ph0 * pw if within_row else 0
        shift = (pw0 * stride - 2) - (pw0 * stride - 2) // unit * unit
        pos = np.arange(pos0, min(phw, pos0 + rk))
        ph, pwv = pos // pw, pos % pw
        assert ((ph - ph0) * stride + k - 1).max() < hp
        assert (shift + (pwv - pw0) * stride + k - 1).max() < wp
        assert (pwv >= pw0).all() and 0 <= shift < unit


def _assert_one_tma_path(s_shape, u_shape, stride, esz, p):
    """The launch ``p`` takes the kernel's one asynchronous path: its patch
    is the one ``patch_shape`` gives and holds every tap within TMA's box
    limit, the block's shared memory fits in the 227 KB an SM grants one
    block, and both operands lie on row pitches of whole 16-byte units,
    each its row rounded up (TMA's rule for a row stride)."""
    assert (p.cp, p.hp, p.wp, p.within_row) == dw.patch_shape(p.mt, 5, stride, s_shape[1],
                                                              u_shape[3], esz)
    _patch_holds_every_tap(stride, u_shape[3], esz, p.hp, p.wp, p.within_row)
    assert p.cp <= 256 and dw.smem_bytes(p.nt, p.cp * p.hp * p.wp * esz, esz) <= 232448
    unit = 16 // esz
    for row, row_pitch in ((s_shape[3], p.s_pitch), (u_shape[2] * u_shape[3], p.u_pitch)):
        assert row_pitch % unit == 0 and row <= row_pitch < row + unit


@pytest.mark.parametrize("s_shape,u_shape,stride", STEP_CALLS + RES100_CALLS, ids=[
    "-".join(map(str, _m_n_tiles(s, u))) for s, u, _ in STEP_CALLS + RES100_CALLS])
def test_plan_covers_the_reduction(s_shape, u_shape, stride):
    """Every tile in exactly one split; the narrowest N extent that covers
    n (three output channels: a 64 x 8 tile); splits at least MIN_TILES
    long; at least 95% of a wave of blocks on the card wherever the
    reduction is long enough to split that far; and the launch takes the
    kernel's one asynchronous path (``_assert_one_tma_path``)."""
    m, n, tiles = _m_n_tiles(s_shape, u_shape)
    p = dw.plan(s_shape, u_shape, 5, stride)
    assert p.nt == next((t for t in dw.TILE_N if n <= t), 128) and p.mt in (64, 128)
    assert (p.splits - 1) * p.chunk < tiles <= p.splits * p.chunk
    assert p.splits == 1 or p.chunk >= dw.MIN_TILES
    blocks = -(-m // p.mt) * -(-n // p.nt)
    assert blocks * p.splits >= min(0.95 * dw.SMS, blocks * (tiles // dw.MIN_TILES))
    if n == 3:
        assert (p.mt, p.nt) == (64, 8)
    _assert_one_tma_path(s_shape, u_shape, stride, 4, p)


PRESET_CASES = [(s, u, stride, per, esz) for size in sorted(set(PRESET_SIZES.values()))
                for s, u, stride, per in PRESET_CALLS[size] for esz in (4, 2)]


@pytest.mark.parametrize("s_row,u_row,stride,per,esz", PRESET_CASES, ids=[
    f"{s[1]}px-" + "-".join(map(str, (*_m_n_tiles((per, *s), (per, *u), esz)[:2], esz)))
    for s, u, _, per, esz in PRESET_CASES])
def test_every_preset_call_takes_the_tma_path(s_row, u_row, stride, per, esz):
    """Every weight grad of every preset (``PRESET_CALLS``) at every batch of
    ``PRESET_BATCHES``, with fp32 and with bf16 operands: every tile in
    exactly one split of at least MIN_TILES tiles, the narrowest N extent
    that covers n, and the kernel's one asynchronous path
    (``_assert_one_tma_path``): no call is left to another way of loading."""
    for b in PRESET_BATCHES:
        s_shape, u_shape = (b * per, *s_row), (b * per, *u_row)
        _, n, tiles = _m_n_tiles(s_shape, u_shape, esz)
        p = dw.plan(s_shape, u_shape, 5, stride, esz)
        assert p.nt == next((t for t in dw.TILE_N if n <= t), 128) and p.mt in (64, 128)
        assert (p.splits - 1) * p.chunk < tiles <= p.splits * p.chunk
        assert p.splits == 1 or p.chunk >= dw.MIN_TILES
        _assert_one_tma_path(s_shape, u_shape, stride, esz, p)


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for one test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("preset", sorted(PRESET_SIZES))
def test_preset_calls_are_the_steps_own(preset, monkeypatch):
    """``PRESET_CALLS`` holds every weight grad of the preset's stage-I
    VAE/GAN step (encoder, decoder twice, discriminator over 3 images per
    row) and of its VoxelDecoder and WaeDecoder, at batch 2 with
    ``pallas_backward``; the WAE paths and the cognitive stages reuse these
    nets. The voxels feed only fc layers, so they are cut to 64 here. Only
    the shapes are compared, so torch runs on one thread: on the suite's
    busy workers a full-size step on every thread took 70-120 s."""
    import dataclasses

    from fmri_tpu_torch.configs import presets
    from fmri_tpu_torch.models import nets
    from fmri_tpu_torch.train.optim import RmsProp
    from fmri_tpu_torch.train.state import GROUPS, VaeGan, make_state
    from fmri_tpu_torch.train.steps_vgan import make_vgan_stage1_step

    seen = set()
    for name in ("conv2d_dw", "conv2d_transpose_dw"):
        orig = getattr(dw, name)

        def recorded(x, dy, stride, *rest, _orig=orig, _name=name):
            s, u = (x, dy) if _name == "conv2d_dw" else (dy, x)
            seen.add((tuple(s.shape[1:]), tuple(u.shape[1:]), stride, s.shape[0] // 2))
            return _orig(x, dy, stride, *rest)

        monkeypatch.setattr(dw, name, recorded)
    cfg = presets.override_num_voxels(presets.get_config(preset), 64)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pallas_backward=True))
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    s, latent = cfg.model.image_size, cfg.model.latent_dim
    x = torch.from_numpy(rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32))
    eps, z_p = (torch.from_numpy(rng.normal(size=(2, latent)).astype(np.float32))
                for _ in range(2))
    vaegan = VaeGan(cfg)
    state = make_state(vaegan, {g: RmsProp() for g in GROUPS})
    make_vgan_stage1_step(cfg).train_step(state, x, eps, z_p, 0.35, 0.68, 1e-6)
    for module, width in ((nets.VoxelDecoder, cfg.model.num_voxels),
                          (nets.WaeDecoder, latent)):
        m = module(cfg.model).train()
        out = m(torch.from_numpy(rng.normal(size=(2, width)).astype(np.float32)))
        outs = out if isinstance(out, tuple) else (out,)
        torch.autograd.grad(sum((o * o).sum() for o in outs), list(m.parameters()))
    assert seen == set(PRESET_CALLS[PRESET_SIZES[preset]])


def _tf32(a):
    """cvt.rna.tf32.f32: fp32 to the nearest value with 10 mantissa bits,
    ties away from zero (the 13 dropped bits rounded on the magnitude)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                  1 + 2 ** -12, 3.0], np.float32)
    np.testing.assert_array_equal(_tf32(x), [one + ulp, -(one + ulp), one, one, 3.0])


def _split3_dot(a, b, splits, chunk, rk=32):
    """D[m, n] = sum_r a[r, m] b[r, n] as csrc/dw.cu computes it from fp32
    operands: hi = tf32(x), lo = tf32(x - hi) for both; per tile of rk
    rows the exact sum of lo_a hi_b + hi_a lo_b + hi_a hi_b (products of
    11-bit mantissas are exact in float64, and the tensor core adds a tile
    at a time), added into an fp32 accumulator tile by tile in each split,
    then the fp32 sum of the splits in order."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    t = a.shape[0] // rk

    def tiles(x, y):
        return np.einsum("trm,trn->tmn", x.astype(np.float64).reshape(t, rk, -1),
                         y.astype(np.float64).reshape(t, rk, -1))

    per_tile = tiles(al, bh) + tiles(ah, bl) + tiles(ah, bh)
    acc = np.zeros((splits,) + per_tile.shape[1:], np.float32)
    for i in range(chunk):
        idx = np.arange(splits) * chunk + i
        live = idx < t
        acc[live] += per_tile[idx[live]].astype(np.float32)
    out = acc[0].copy()
    for z in range(1, splits):
        out += acc[z]
    return out


def test_split_tf32_arithmetic_holds_the_fp32_bound():
    """At the step's longest reduction (the discriminator's first conv: S
    [192, 3, 64, 64], U [192, 32, 64, 64], 786,432 rows), the kernel's
    3xTF32 arithmetic, emulated, stays within 1e-5 of the largest magnitude
    of the float64 result; one TF32 pass would not. A slice of the call:
    one input channel's five centre-row taps against four output channels
    (each output is its own sum over the full reduction)."""
    rng = np.random.default_rng(0)
    b, hw = 192, 64
    x = rng.uniform(-1, 1, (b, hw + 4, hw + 4)).astype(np.float32)
    x[:, :2], x[:, -2:], x[:, :, :2], x[:, :, -2:] = 0, 0, 0, 0  # the zero padding
    a = np.stack([x[:, 2:2 + hw, kw:kw + hw].reshape(-1) for kw in range(5)], 1)
    u = rng.normal(size=(b * hw * hw, 4)).astype(np.float32)
    splits, chunk = dw.plan((b, 3, hw, hw), (b, 32, hw, hw), 5, 1)[2:4]
    exact = a.astype(np.float64).T @ u.astype(np.float64)
    scale = np.abs(exact).max()
    got = _split3_dot(a, u, splits, chunk)
    assert np.abs(got - exact).max() <= 1e-5 * scale
    one_pass = _tf32(a).astype(np.float64).T @ _tf32(u).astype(np.float64)
    assert np.abs(one_pass - exact).max() > 1e-5 * scale


@pytest.mark.parametrize("esz", [4, 2])
@pytest.mark.parametrize("s_hw,stride,pw", [(64, 1, 64), (64, 2, 32), (32, 2, 16),
                                             (16, 2, 8), (32, 1, 32), (9, 2, 5),
                                             # res100's and tiny's geometries
                                             (100, 1, 100), (100, 2, 50), (50, 2, 25),
                                             (25, 2, 13), (13, 2, 7), (16, 1, 16),
                                             (8, 2, 4), (4, 2, 2)])
def test_patch_holds_every_tap_of_a_tile(s_hw, stride, pw, esz):
    """``patch_shape``'s patch for S rows of ``s_hw`` and U rows of ``pw``
    holds every (tap, position) pair of every tile (``_patch_holds_every_tap``)."""
    _, hp, wp, within_row = dw.patch_shape(64, 5, stride, 8, pw, esz)
    _patch_holds_every_tap(stride, pw, esz, hp, wp, within_row)


def _count_dw_calls(monkeypatch):
    calls = []
    for name in ("conv2d_dw", "conv2d_transpose_dw"):
        orig = getattr(dw, name)

        def counted(*args, _orig=orig, _name=name):
            calls.append(_name)
            return _orig(*args)

        monkeypatch.setattr(dw, name, counted)
    return calls


@pytest.mark.parametrize("kind", ["conv", "deconv"])
def test_weight_grad_runs_only_when_asked(kind, monkeypatch):
    """The weight grad is its own autograd node: a pullback to the input
    alone makes no weight-grad call, one to (input, weight) makes one, and
    both gradients equal stock autograd's (dx bit for bit)."""
    calls = _count_dw_calls(monkeypatch)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 6, 8, 8)).astype(np.float32))
    if kind == "conv":
        w = torch.from_numpy(0.1 * rng.normal(size=(4, 6, 5, 5)).astype(np.float32))
        fwd = lambda a, b: conv.conv2d(a, b, 2, 2, None, True)  # noqa: E731
        ref_fn = lambda a, b: F.conv2d(a, b, stride=2, padding=2)  # noqa: E731
    else:
        w = torch.from_numpy(0.1 * rng.normal(size=(6, 4, 5, 5)).astype(np.float32))
        fwd = lambda a, b: conv.conv2d_transpose(a, b, 2, 2, 1, None, True)  # noqa: E731
        ref_fn = lambda a, b: F.conv_transpose2d(  # noqa: E731
            a, b, stride=2, padding=2, output_padding=1)
    x.requires_grad_()
    w.requires_grad_()
    y, ref = fwd(x, w), ref_fn(x, w)
    dy = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    dx, = torch.autograd.grad(y, [x], dy, retain_graph=True)
    assert calls == []
    dx2, dw_ = torch.autograd.grad(y, [x, w], dy)
    assert len(calls) == 1
    rx, rw = torch.autograd.grad(ref, [x, w], dy)
    assert torch.equal(dx, rx) and torch.equal(dx2, rx)
    np.testing.assert_allclose(dw_.numpy(), rw.numpy(), rtol=2e-5, atol=2e-4)


def test_spliced_step_makes_one_weight_grad_per_conv_use(monkeypatch):
    """One spliced ``tiny`` step with ``pallas_backward``: as many weight-grad
    calls as the step has conv/deconv weight uses to update (encoder 3,
    decoder 4 in each of its two passes, discriminator 4: 15); the
    feature-basis pullback through the discriminator and the z pullback
    through the decoder make none."""
    import dataclasses

    from fmri_tpu_torch.configs import presets
    from fmri_tpu_torch.train.optim import RmsProp
    from fmri_tpu_torch.train.state import GROUPS, VaeGan, make_state
    from fmri_tpu_torch.train.steps_vgan import make_vgan_stage1_step

    cfg = presets.get_config("tiny")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             pallas_backward=True))
    torch.manual_seed(0)
    nets = VaeGan(cfg)
    convs = {g: sum(isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
                    for mod in getattr(nets, g).modules()) for g in GROUPS}
    calls = _count_dw_calls(monkeypatch)
    rng = np.random.default_rng(0)
    s, latent = cfg.model.image_size, cfg.model.latent_dim
    x = torch.from_numpy(rng.uniform(-1, 1, (4, s, s, 3)).astype(np.float32))
    eps, z_p = (torch.from_numpy(rng.normal(size=(4, latent)).astype(np.float32))
                for _ in range(2))
    state = make_state(nets, {g: RmsProp() for g in GROUPS})
    make_vgan_stage1_step(cfg).train_step(state, x, eps, z_p, 0.35, 0.68, 1e-6)
    want = convs["encoder"] + 2 * convs["decoder"] + convs["discriminator"]
    assert (convs["encoder"], convs["decoder"], convs["discriminator"]) == (3, 4, 4)
    assert len(calls) == want == 15
    assert calls.count("conv2d_transpose_dw") == 2 * 3


def test_wrappers_check_their_operands():
    x = torch.zeros(2, 3, 8, 8)
    with pytest.raises(ValueError, match="not the output"):
        dw.conv2d_dw(x, torch.zeros(2, 4, 5, 5), 2, 2, 5)
    with pytest.raises(ValueError, match="not the output"):
        dw.conv2d_transpose_dw(x, torch.zeros(2, 4, 16, 16), 2, 2, 0, 5)
    with pytest.raises(ValueError, match="CUDA"):
        dw.tap_matmul(x, torch.zeros(2, 4, 8, 8), 5, 1, 2)
    with pytest.raises(ValueError, match="batch"):
        dw.conv2d_dw(x, torch.zeros(3, 4, 8, 8), 1, 2, 5)
