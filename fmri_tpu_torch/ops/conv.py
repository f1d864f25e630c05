"""Forward convolutions and dense layers with the reference's geometry, and
the optional hand-written weight-grad backward of the 5x5 convs.

NCHW activations, torch weight layouts (Conv2d OIHW, ConvTranspose2d IOHW,
Linear [out, in]). The forwards stay cuDNN/cuBLAS calls: the JAX package
leaves them to XLA, not to Pallas. ``compute_dtype='bfloat16'`` casts both
operands to bf16 and the result back to fp32, as ``fmri_tpu/ops/conv.py:27-37``
does, so BatchNorm and everything after it stays fp32.

``pallas_backward=True`` (``ModelConfig.pallas_backward``) routes
:func:`conv2d` and :func:`conv2d_transpose` through two ``torch.autograd``
Functions per layer: one takes dx from the stock input grad, the other
(:class:`_WeightGrad`, its own graph node) takes dW from ``ops/dw.py`` (the
CUDA kernel on the card) and runs only when the weight's gradient is asked
for, as ``fmri_tpu/ops/conv.py:86-117, 194-231`` compute them. The gate is
the JAX one (:62-63, :176-177): stride 1, or k5/p2/s2 (deconv: k5/p2/s2
only); any other geometry takes the stock backward in both packages.

``alt_backward=True`` (``ModelConfig.alt_backward``) routes :func:`conv2d`
through the same pair of Functions with the rewrites of ``ops/conv_alt.py``
(``fmri_tpu/ops/conv.py:66-70, 120-149``): dx by phases for a k5/p2/s2 conv
with even H and W, and the stock weight grad; dW by patches for a stride-1
conv with at most 16 output channels, and the stock input grad. Any other
conv takes the stock backward; ``pallas_backward`` wins when both are set;
:func:`conv2d_transpose` has no alt route.

No tap flip happens in :func:`conv2d_transpose`: torch's transposed conv
already scatters its kernel the way the reference's ``ConvTranspose2d`` does;
the 180-degree rotation between the JAX correlation layout and this one lives
in the weight converter (``fmri_tpu_torch.checkpoints.convert``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fmri_tpu_torch.ops import conv_alt, dw


def _operands(compute_dtype: str | None, *ts):
    if compute_dtype in (None, "float32"):
        return ts
    cd = getattr(torch, compute_dtype)
    return tuple(None if t is None else t.to(cd) for t in ts)


def _result(y: torch.Tensor, compute_dtype: str | None) -> torch.Tensor:
    """fp32 after a cast to the compute dtype; otherwise the operands' own
    dtype, as ``fmri_tpu/ops/conv.py:27-37`` casts back only what it cast."""
    return y if compute_dtype in (None, "float32") else y.float()


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None,
           compute_dtype: str | None = None) -> torch.Tensor:
    """``x @ weight.T + bias``; bf16 operands (bias included, as a flax
    ``Dense(dtype=bf16)`` does) give an fp32 result."""
    x, weight, bias = _operands(compute_dtype, x, weight, bias)
    return _result(F.linear(x, weight, bias), compute_dtype)


def _conv(x, weight, stride, padding, compute_dtype):
    x, weight = _operands(compute_dtype, x, weight)
    return _result(F.conv2d(x, weight, stride=stride, padding=padding), compute_dtype)


def _deconv(x, weight, stride, padding, output_padding, compute_dtype):
    x, weight = _operands(compute_dtype, x, weight)
    return _result(F.conv_transpose2d(x, weight, stride=stride, padding=padding,
                                      output_padding=output_padding), compute_dtype)


def _input_grad(dy, x, weight, stride, padding, output_padding, transposed,
                compute_dtype):
    """The stock input grad, as autograd of the forward computes it: dy
    cast to the compute dtype, ``convolution_backward`` for the input only,
    the result cast back to x's dtype."""
    dyc, xc, wc = _operands(compute_dtype, dy, x, weight)
    dx = torch.ops.aten.convolution_backward(
        dyc.to(xc.dtype), xc, wc, None, [stride] * 2, [padding] * 2, [1, 1],
        transposed, [output_padding] * 2, 1, [True, False, False])[0]
    return dx.to(x.dtype)


def _stock_weight_grad(dy, x, weight, stride, padding, compute_dtype):
    """The stock weight grad of a conv, as autograd of the forward computes
    it: ``convolution_backward`` for the weight only in the compute dtype,
    the result cast back to the weight's dtype."""
    dyc, xc, wc = _operands(compute_dtype, dy, x, weight)
    dw_ = torch.ops.aten.convolution_backward(
        dyc.to(xc.dtype), xc, wc, None, [stride] * 2, [padding] * 2, [1, 1],
        False, [0, 0], 1, [False, True, False])[1]
    return dw_.to(weight.dtype)


class _WeightGrad(torch.autograd.Function):
    """The weight-grad node of a ``pallas_backward`` or ``alt_backward``
    conv or deconv. Its output is a placeholder (one zero, broadcast to the
    layer's output shape) that the input-grad Function takes as an extra
    input and hands ``dy`` back through, so autograd runs this node, and
    launches ``ops/dw.py``, only when the weight's gradient is asked for: a
    pullback to the input alone prunes it, as XLA's DCE prunes the dW of the
    JAX step. ``route`` is ``"pallas"`` (``ops/dw.py``), ``"patches"``
    (``conv_alt.conv2d_dw_patches``) or ``"stock"``."""

    @staticmethod
    def forward(ctx, weight, x, out_shape, out_dtype, geometry):
        ctx.save_for_backward(x)
        ctx.weight_meta = (weight.shape, weight.dtype)
        ctx.geometry = geometry
        return x.new_zeros((), dtype=out_dtype).expand(out_shape)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        shape, dtype = ctx.weight_meta
        route, stride, padding, output_padding, transposed, cd = ctx.geometry
        k = shape[-1]
        if route == "stock":  # the library needs the weight's shape, not its values
            weight = x.new_empty(shape, dtype=dtype)
            return _stock_weight_grad(dy, x, weight, stride, padding, cd), \
                None, None, None, None
        xc, dyc = _operands(cd, x, dy)
        if route == "patches":
            dw_ = conv_alt.conv2d_dw_patches(xc, dyc, padding, k)
        elif transposed:
            dw_ = dw.conv2d_transpose_dw(xc.contiguous(), dyc.contiguous(), stride,
                                         padding, output_padding, k)
        else:
            dw_ = dw.conv2d_dw(xc.contiguous(), dyc.contiguous(), stride, padding, k)
        return dw_.to(dtype), None, None, None, None


class _Conv2dDW(torch.autograd.Function):
    """The forward conv and its input grad, stock or (``phases``) by
    ``conv_alt.conv2d_dx_phases``; ``tap`` (the :class:`_WeightGrad`
    placeholder) receives ``dy`` for the weight grad."""

    @staticmethod
    def forward(ctx, x, weight, tap, stride, padding, compute_dtype, phases):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (stride, padding, compute_dtype, phases)
        return _conv(x, weight, stride, padding, compute_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        stride, padding, cd, phases = ctx.geometry
        dx = None
        if ctx.needs_input_grad[0] and phases:
            dyc, wc = _operands(cd, dy, weight)
            dx = conv_alt.conv2d_dx_phases(dyc, wc, x.shape[2:], padding).to(x.dtype)
        elif ctx.needs_input_grad[0]:
            dx = _input_grad(dy, x, weight, stride, padding, 0, False, cd)
        return dx, None, dy if ctx.needs_input_grad[2] else None, None, None, None, None


class _Deconv2dDW(torch.autograd.Function):
    """The forward deconv and its stock input grad; ``tap`` as in
    :class:`_Conv2dDW`."""

    @staticmethod
    def forward(ctx, x, weight, tap, stride, padding, output_padding, compute_dtype):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (stride, padding, output_padding, compute_dtype)
        return _deconv(x, weight, stride, padding, output_padding, compute_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        stride, padding, output_padding, cd = ctx.geometry
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(dy, x, weight, stride, padding, output_padding, True, cd)
        return dx, None, dy if ctx.needs_input_grad[2] else None, None, None, None, None


def _out_dtype(x: torch.Tensor, compute_dtype: str | None) -> torch.dtype:
    return x.dtype if compute_dtype in (None, "float32") else torch.float32


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
           padding: int = 0, compute_dtype: str | None = None,
           pallas_backward: bool = False, alt_backward: bool = False) -> torch.Tensor:
    """``nn.Conv2d(k, s, p)`` forward, no bias. x: [B, Ci, H, W];
    weight: [Co, Ci, k, k]. ``pallas_backward`` takes dW from ``ops/dw.py``
    for stride 1 or k5/p2/s2; otherwise ``alt_backward`` takes dx by phases
    for k5/p2/s2 with even H and W, or dW by patches for stride 1 with at
    most 16 output channels."""
    k, co = weight.shape[-1], weight.shape[0]
    s2 = stride == 2 and k == 5 and padding == 2
    even = x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0
    if pallas_backward and (stride == 1 or s2):
        route, phases = "pallas", False
    elif alt_backward and (s2 and even):
        route, phases = "stock", True
    elif alt_backward and stride == 1 and co <= 16:
        route, phases = "patches", False
    else:
        return _conv(x, weight, stride, padding, compute_dtype)
    shape = (x.shape[0], co, *(dw._out_size(n, k, stride, padding) for n in x.shape[2:]))
    tap = _WeightGrad.apply(weight, x.detach(), shape, _out_dtype(x, compute_dtype),
                            (route, stride, padding, 0, False, compute_dtype))
    return _Conv2dDW.apply(x, weight.detach(), tap, stride, padding, compute_dtype,
                           phases)


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor, stride: int = 2,
                     padding: int = 2, output_padding: int = 0,
                     compute_dtype: str | None = None,
                     pallas_backward: bool = False) -> torch.Tensor:
    """``nn.ConvTranspose2d(k, s, p, output_padding)`` forward, no bias:
    out = (in - 1) * stride - 2 * padding + k + output_padding.
    x: [B, Ci, H, W]; weight: [Ci, Co, k, k]. ``pallas_backward`` takes dW
    from ``ops/dw.py`` for k5/p2/s2."""
    k = weight.shape[-1]
    if pallas_backward and stride == 2 and padding == 2 and k == 5:
        shape = (x.shape[0], weight.shape[1], *((n - 1) * stride - 2 * padding + k
                                                + output_padding for n in x.shape[2:]))
        tap = _WeightGrad.apply(weight, x.detach(), shape,
                                _out_dtype(x, compute_dtype),
                                ("pallas", stride, padding, output_padding, True,
                                 compute_dtype))
        return _Deconv2dDW.apply(x, weight.detach(), tap, stride, padding,
                                 output_padding, compute_dtype)
    return _deconv(x, weight, stride, padding, output_padding, compute_dtype)
