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


def _emulate_kernel(shifted, direct, k, stride, pad):
    """csrc/dw.cu's arithmetic in numpy: the wrapper's plan (tile, splits,
    chunk), each split's rows r = (b, ph, pw) and columns m = (cs, kh, kw)
    decoded and bounds-checked as the kernel does, partial tiles per split,
    and the second pass's sum over splits."""
    b, cs, hs, ws = shifted.shape
    _, cu, ph_n, pw_n = direct.shape
    m_n, r_n = cs * k * k, b * ph_n * pw_n
    _, splits, chunk = dw.plan(m_n, cu, r_n)
    s_flat, u_flat = shifted.reshape(-1), direct.reshape(-1)
    m = np.arange(m_n)
    c_s, t = m // (k * k), m % (k * k)
    dh, dwv = t // k - pad, t % k - pad
    out = np.zeros((cu, m_n))
    for z in range(splits):
        r = np.arange(z * chunk, min(r_n, (z + 1) * chunk))
        bb, rem = r // (ph_n * pw_n), r % (ph_n * pw_n)
        ph, pw = rem // pw_n, rem % pw_n
        h = ph[:, None] * stride + dh[None]
        w = pw[:, None] * stride + dwv[None]
        ok = (h >= 0) & (h < hs) & (w >= 0) & (w < ws)
        at = (bb * cs * hs * ws)[:, None] + (c_s * hs * ws)[None] + h * ws + w
        a = np.where(ok, s_flat[np.where(ok, at, 0)], 0.0)
        u = u_flat[(bb * cu * ph_n * pw_n + ph * pw_n + pw)[:, None]
                   + np.arange(cu)[None] * ph_n * pw_n]
        out += u.T @ a
    return out.reshape(cu, cs, k, k)


@pytest.mark.parametrize("kind,b,ci,h,co,stride", [
    ("conv", 4, 3, 64, 32, 1), ("conv", 2, 16, 16, 8, 2), ("conv", 2, 8, 8, 3, 1),
    ("deconv", 2, 16, 8, 8, 2), ("deconv", 2, 4, 5, 3, 2)])
def test_kernel_index_arithmetic_emulated(kind, b, ci, h, co, stride):
    """The CUDA kernel cannot run here; its indexing and split plan,
    emulated, give the plain weight grad (float64: atol 1e-9)."""
    rng = np.random.default_rng(b + ci + h + co)
    x = rng.normal(size=(b, ci, h, h))
    if kind == "conv":
        oh = (h + 4 - 5) // stride + 1
        dy = rng.normal(size=(b, co, oh, oh))
        ref = dw.conv2d_dw_plain(torch.from_numpy(x).double(),
                                 torch.from_numpy(dy).double(), stride, 2, 5)
        got = _emulate_kernel(x, dy, 5, stride, 2)
    else:
        oh = 2 * h
        dy = rng.normal(size=(b, co, oh, oh))
        ref = dw.conv2d_transpose_dw_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                           2, 2, 1, 5)
        got = _emulate_kernel(dy, x, 5, 2, 2)
    np.testing.assert_allclose(got, ref.double().numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,n,r", [(75, 32, 786432), (3200, 256, 4096),
                                   (1600, 3, 262144), (6400, 256, 4096), (25, 1, 3)])
def test_plan_covers_the_reduction(m, n, r):
    tile, splits, chunk = dw.plan(m, n, r)
    tm, tn = dw.TILES[tile]
    assert n <= tn or tile == 0
    assert chunk % dw.RK == 0 and (splits - 1) * chunk < r <= splits * chunk
    tiles = -(-m // tm) * -(-n // tn)
    # enough blocks to fill the card, or every split at least MIN_ROWS long
    assert tiles * splits >= min(dw.TARGET_BLOCKS // 2, tiles * -(-r // dw.MIN_ROWS))
    assert splits == 1 or chunk >= dw.MIN_ROWS


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
