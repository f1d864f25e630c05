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


def _emulate_kernel(shifted, direct, k, stride, pad, esz=4):
    """csrc/dw.cu's indexing in numpy (float64): the wrapper's plan (mt, nt,
    splits, chunk and the S patch [Cp, Hp, Wp]); the reduction in tiles of RK positions of one image,
    zero past PH*PW (TMA's out-of-bounds fill for U); n padded to whole nt
    tiles (zero past Cu); per block of mt rows and per tile, the S patch
    [Cp, Hp, Wp] at (cs_lo, h0, w0) with zeros outside S, each thread's row
    offset (channel, kh, kw; rows past M clamped to the last) and each
    position's offset (ph, pw) into it; one partial per split, and the
    second pass's sum over splits in split order."""
    b, cs, hs, ws = shifted.shape
    _, cu, ph_n, pw_n = direct.shape
    m_n, phw, rk = cs * k * k, ph_n * pw_n, dw.ROW_BYTES // esz
    per_image = -(-phw // rk)
    mt, nt, splits, chunk, cp, hp, wp, within_row = dw.plan(shifted.shape, direct.shape,
                                                            k, stride, esz)
    n_pad = -(-cu // nt) * nt
    u_pad = np.zeros((b, n_pad, per_image * rk))
    u_pad[:, :cu, :phw] = direct.reshape(b, cu, phw)
    s_pad = np.zeros((b, cs + cp, hs + 2 * hp + 2 * pad, ws + 2 * wp + 2 * pad))
    oh, ow = hp + pad, wp + pad  # where S[.., 0, 0] sits in s_pad
    s_pad[:, :cs, oh:oh + hs, ow:ow + ws] = shifted
    partial = np.zeros((splits, n_pad, m_n))
    for m0 in range(0, m_n, mt):
        cs_lo = m0 // (k * k)
        m = np.minimum(np.arange(m0, m0 + mt), m_n - 1)
        c, tap = m // (k * k) - cs_lo, m % (k * k)
        mb = (c * hp + tap // k) * wp + tap % k
        for z in range(splits):
            for tile in range(z * chunk, min(b * per_image, (z + 1) * chunk)):
                bb, pos0 = tile // per_image, (tile % per_image) * rk
                ph0 = pos0 // pw_n
                pw0 = pos0 - ph0 * pw_n if within_row else 0
                h0 = ph0 * stride - pad
                w0 = (pw0 * stride - pad) // (16 // esz) * (16 // esz)  # 16-byte start
                shift = pw0 * stride - pad - w0
                patch = s_pad[bb, cs_lo:cs_lo + cp, oh + h0:oh + h0 + hp,
                              ow + w0:ow + w0 + wp].reshape(-1)
                pos = pos0 + np.arange(rk)
                ph = pos // pw_n
                ro = shift + np.where(pos < phw, (ph - ph0) * stride * wp
                                      + (pos - ph * pw_n - pw0) * stride, 0)
                a = patch[ro[:, None] + mb[None]]                      # [rk, mt]
                rows = slice(m0, min(m0 + mt, m_n))
                partial[z][:, rows] += (u_pad[bb, :, pos0:pos0 + rk]
                                        @ a)[:, :rows.stop - m0]
    out = partial[0]
    for z in range(1, splits):
        out = out + partial[z]
    return out[:cu].reshape(cu, cs, k, k)


@pytest.mark.parametrize("kind,b,ci,h,co,stride", [
    ("conv", 4, 3, 64, 32, 1), ("conv", 2, 16, 16, 8, 2), ("conv", 2, 8, 8, 3, 1),
    ("deconv", 2, 16, 8, 8, 2), ("deconv", 2, 4, 5, 3, 2), ("conv", 3, 5, 9, 7, 2),
    ("conv", 2, 8, 64, 4, 2), ("conv", 2, 4, 32, 130, 1)])
def test_kernel_index_arithmetic_emulated(kind, b, ci, h, co, stride):
    """The CUDA kernel cannot run here; its indexing, padding and split
    plan, emulated in float64, give the plain weight grad (which sums in
    fp32: rtol 1e-5, atol 1e-4)."""
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
        got = _emulate_kernel(dy, x, 5, 2, 2, esz=2)  # bf16 tiles: 64 positions
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


def _m_n_tiles(s_shape, u_shape):
    """(m, n, reduction tiles) of a call with fp32 operands."""
    return s_shape[1] * 25, u_shape[1], s_shape[0] * -(-(u_shape[2] * u_shape[3]) // 32)


@pytest.mark.parametrize("s_shape,u_shape,stride", STEP_CALLS + RES100_CALLS, ids=[
    "-".join(map(str, _m_n_tiles(s, u))) for s, u, _ in STEP_CALLS + RES100_CALLS])
def test_plan_covers_the_reduction(s_shape, u_shape, stride):
    """Every tile in exactly one split; the narrowest N extent that covers
    n (three output channels: a 64 x 8 tile); splits at least MIN_TILES
    long; at least 95% of a wave of blocks on the card wherever the
    reduction is long enough to split that far; and the patch of the plan
    is the one ``patch_shape`` gives, with the block's shared memory inside
    the 227 KB an SM grants one block."""
    m, n, tiles = _m_n_tiles(s_shape, u_shape)
    mt, nt, splits, chunk, cp, hp, wp, within_row = dw.plan(s_shape, u_shape, 5, stride)
    assert nt == next((t for t in dw.TILE_N if n <= t), 128) and mt in (64, 128)
    assert (splits - 1) * chunk < tiles <= splits * chunk
    assert splits == 1 or chunk >= dw.MIN_TILES
    blocks = -(-m // mt) * -(-n // nt)
    assert blocks * splits >= min(0.95 * dw.SMS, blocks * (tiles // dw.MIN_TILES))
    if n == 3:
        assert (mt, nt) == (64, 8)
    assert (cp, hp, wp, within_row) == dw.patch_shape(mt, 5, stride, s_shape[1], u_shape[3])
    assert dw.smem_bytes(nt, cp * hp * wp * 4) <= 232448


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
                                             (16, 2, 8), (32, 1, 32), (9, 2, 5)])
def test_patch_holds_every_tap_of_a_tile(s_hw, stride, pw, esz):
    """Every (tap, position) pair of every tile reads inside its stage's S
    patch: kh plus the position's row offset below Hp, kw plus its column
    offset (from the patch's 16-byte-aligned first column) below Wp, so a TMA
    box of [Cp, Hp, Wp] is enough; Wp a whole number of 16-byte units."""
    k, rk, unit = 5, dw.ROW_BYTES // esz, 16 // esz
    _, hp, wp, within_row = dw.patch_shape(64, k, stride, 8, pw, esz)
    assert (wp * esz) % 16 == 0
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
