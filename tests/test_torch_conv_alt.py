"""The port's conv-backward rewrites (``fmri_tpu_torch/ops/conv_alt.py``) and
their ``alt_backward`` routing (``fmri_tpu_torch/ops/conv.py``) against the
JAX package's ``fmri_tpu/ops/conv_alt.py`` and ``conv.conv2d(alt_backward=
True)``, and against torch autograd's stock grads, on the CPU; then the
stage-I VAE/GAN step with ``alt_backward`` against the JAX step with it.

Tolerances, relative to the largest magnitude of the reference:
  * fp32 operands: 1e-5 (both sides accumulate in fp32 in other orders);
  * bf16 operands: the patches dW 1e-5 (bf16 products are exact in fp32,
    the sums fp32 on both sides); the phases dX 8e-3 against the JAX
    function, whose phases also round to bf16 (one bf16 unit, 2^-8, is
    3.9e-3 relative: the two frameworks may round one sum either way) and
    against float64 stock grads of the same bf16 operands;
  * the routed conv against the stock backward: fp32 rtol 2e-5, atol 2e-4;
    bf16 rtol 0.03, atol 0.05, the bounds of ``tests/test_conv_alt.py``
    (the stock backward rounds dy to bf16, the rewrite its phases);
  * the step: ``tests/test_torch_train.py``'s tiny fp32 bounds (losses 1e-6
    relative, parameter movement 1e-3, statistics and moments 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_train import (
    LAMBDA_MSE, MARGIN, _compare, _configs, _images, _jax_state, _noise, _port_state,
)
from test_torch_wae import count_kernel_calls

from fmri_tpu.ops import conv as jax_conv
from fmri_tpu.ops import conv_alt as jax_alt
from fmri_tpu.train import make_vgan_stage1_step as jax_step
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.ops import conv, conv_alt
from fmri_tpu_torch.train.steps_vgan import make_vgan_stage1_step

TOL = dict(loss=1e-6, param=1e-3, stats=1e-5, sq=1e-5)
DTYPES = [None, "bfloat16"]


def _rand(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _cast(a: np.ndarray, dtype):
    """A numpy array rounded to ``dtype`` (bf16 via torch), as float32."""
    t = torch.from_numpy(a)
    return (t if dtype is None else t.to(getattr(torch, dtype))).float().numpy()


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _stock_grads(x, w, dy, stride, padding):
    """float64 autograd of ``F.conv2d`` (NCHW, OIHW): (dx, dW)."""
    xt = torch.from_numpy(x).double().requires_grad_()
    wt = torch.from_numpy(w).double().requires_grad_()
    y = F.conv2d(xt, wt, stride=stride, padding=padding)
    return [g.numpy() for g in torch.autograd.grad(y, [xt, wt],
                                                   torch.from_numpy(dy).double())]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,ci,co,k,p", [(4, 16, 8, 3, 5, 2), (2, 12, 5, 7, 3, 1),
                                           (3, 10, 4, 4, 5, 2)])
def test_dw_patches(b, h, ci, co, k, p, dtype):
    """The shapes of ``tests/test_conv_alt.py``: against the JAX function
    (NHWC/HWIO, transposed) and the float64 stock weight grad of the same
    operands; fp32 out whatever the operands."""
    rng = np.random.default_rng(h)
    x = _cast(_rand(rng, (b, ci, h, h)), dtype)
    dy = _cast(_rand(rng, (b, co, h + 2 * p - k + 1, h + 2 * p - k + 1)), dtype)
    w = np.zeros((co, ci, k, k), np.float32)
    td = None if dtype is None else getattr(torch, dtype)
    xt, dyt = (torch.from_numpy(a) if td is None else torch.from_numpy(a).to(td)
               for a in (x, dy))
    got = conv_alt.conv2d_dw_patches(xt, dyt, p, k)
    assert got.dtype == torch.float32 and got.shape == (co, ci, k, k)
    jd = jnp.float32 if dtype is None else jnp.bfloat16
    ref = jax_alt.conv2d_dw_patches(jnp.asarray(x.transpose(0, 2, 3, 1), jd),
                                    jnp.asarray(dy.transpose(0, 2, 3, 1), jd), p, k)
    _close(got.numpy(), np.asarray(ref).transpose(3, 2, 0, 1), 1e-5)
    _close(got.numpy(), _stock_grads(x, w, dy, 1, p)[1], 1e-5)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,ci,co", [(4, 16, 8, 16), (2, 8, 3, 8), (3, 12, 16, 8)])
def test_dx_phases(b, h, ci, co, dtype):
    """The k5/p2/s2 input grad by phases against the JAX function and the
    float64 stock input grad of the same operands; fp32 out."""
    rng = np.random.default_rng(h + ci)
    w = _cast(_rand(rng, (co, ci, 5, 5), 0.1), dtype)
    dy = _cast(_rand(rng, (b, co, h // 2, h // 2)), dtype)
    x = np.zeros((b, ci, h, h), np.float32)
    td = None if dtype is None else getattr(torch, dtype)
    wt, dyt = (torch.from_numpy(a) if td is None else torch.from_numpy(a).to(td)
               for a in (w, dy))
    got = conv_alt.conv2d_dx_phases(dyt, wt, (h, h))
    assert got.dtype == torch.float32 and got.shape == (b, ci, h, h)
    jd = jnp.float32 if dtype is None else jnp.bfloat16
    ref = jax_alt.conv2d_dx_phases(jnp.asarray(dy.transpose(0, 2, 3, 1), jd),
                                   jnp.asarray(w.transpose(2, 3, 1, 0), jd), (h, h))
    tol = 1e-5 if dtype is None else 8e-3
    _close(got.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), tol)
    _close(got.numpy(), _stock_grads(x, w, dy, 2, 2)[0], tol)


def test_rewrites_check_their_geometry():
    with pytest.raises(ValueError, match="k=5, padding=2"):
        conv_alt.conv2d_dx_phases(torch.zeros((1, 2, 4, 4)), torch.zeros((2, 3, 3, 3)), (8, 8))
    with pytest.raises(ValueError, match="even"):
        conv_alt.conv2d_dx_phases(torch.zeros((1, 2, 13, 13)), torch.zeros((2, 3, 5, 5)),
                                  (25, 25))
    with pytest.raises(ValueError, match="do not match"):
        conv_alt.conv2d_dw_patches(torch.zeros((1, 2, 8, 8)), torch.zeros((1, 3, 7, 7)), 2)


class _Calls:
    """Counts the calls of the two rewrites."""

    def __init__(self, monkeypatch):
        self.n = {"phases": 0, "patches": 0}
        for key, name in (("phases", "conv2d_dx_phases"), ("patches", "conv2d_dw_patches")):
            orig = getattr(conv_alt, name)

            def call(*args, _orig=orig, _key=key):
                self.n[_key] += 1
                return _orig(*args)

            monkeypatch.setattr(conv_alt, name, call)


def _grads(x, w, dy, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = conv.conv2d(xt, wt, padding=2, **kw)
    return [g.numpy() for g in torch.autograd.grad(y, [xt, wt], torch.from_numpy(dy))]


@pytest.mark.parametrize("compute_dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("stride,co", [(2, 8), (1, 3)])
def test_routed_conv(monkeypatch, compute_dtype, stride, co):
    """``conv2d(alt_backward=True)``: stride 2 takes dx by phases and the
    stock dW, stride 1 with 3 output channels dW by patches and the stock
    dx; each half against the stock backward and against the JAX routed
    conv's grads (the shapes of ``tests/test_conv_alt.py``)."""
    calls = _Calls(monkeypatch)
    rng = np.random.default_rng(21)
    x = _rand(rng, (2, 6, 8, 8))
    w = _rand(rng, (co, 6, 5, 5), 0.1)
    dy = _rand(rng, (2, co, 8 // stride, 8 // stride))
    kw = dict(stride=stride, compute_dtype=compute_dtype)
    got = _grads(x, w, dy, alt_backward=True, **kw)
    assert calls.n == {"phases": stride == 2, "patches": stride == 1}
    ref = _grads(x, w, dy, **kw)
    tol = dict(rtol=2e-5, atol=2e-4) if compute_dtype is None else dict(rtol=0.03, atol=0.05)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **tol)
    jx, jw = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0))
    jdy = jnp.asarray(dy.transpose(0, 2, 3, 1))
    jref = jax.grad(lambda a, b: jnp.vdot(jax_conv.conv2d(
        a, b, stride=stride, padding=2, compute_dtype=compute_dtype, alt_backward=True),
        jdy), argnums=(0, 1))(jx, jw)
    _close(got[0], np.asarray(jref[0]).transpose(0, 3, 1, 2),
           1e-5 if compute_dtype is None else 8e-3)
    _close(got[1], np.asarray(jref[1]).transpose(3, 2, 0, 1),
           1e-5 if compute_dtype is None else 8e-3)


def test_odd_spatial_falls_back(monkeypatch):
    """res100's odd 25 x 25 layer cannot split into phases: the stock
    backward, bit for bit, and no rewrite called."""
    calls = _Calls(monkeypatch)
    rng = np.random.default_rng(31)
    x, w = _rand(rng, (2, 4, 25, 25)), _rand(rng, (8, 4, 5, 5), 0.1)
    dy = _rand(rng, (2, 8, 13, 13))
    got = _grads(x, w, dy, stride=2, alt_backward=True)
    ref = _grads(x, w, dy, stride=2)
    assert calls.n == {"phases": 0, "patches": 0}
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("stride,co", [(2, 8), (1, 3)])
def test_pallas_backward_wins(monkeypatch, stride, co):
    """With both flags the weight grad goes to ``ops/dw.py`` and neither
    rewrite runs; the grads equal the ``pallas_backward`` conv's."""
    calls = _Calls(monkeypatch)
    counts = count_kernel_calls(monkeypatch)
    rng = np.random.default_rng(5)
    x, w = _rand(rng, (2, 6, 8, 8)), _rand(rng, (co, 6, 5, 5), 0.1)
    dy = _rand(rng, (2, co, 8 // stride, 8 // stride))
    counts.reset()
    got = _grads(x, w, dy, stride=stride, pallas_backward=True, alt_backward=True)
    assert calls.n == {"phases": 0, "patches": 0} and counts.read() == (0, 0, 1)
    for g, r in zip(got, _grads(x, w, dy, stride=stride, pallas_backward=True)):
        np.testing.assert_array_equal(g, r)


def test_weight_grad_is_pruned_on_a_pullback_to_the_input(monkeypatch):
    """As with ``pallas_backward``, a pullback to the input alone runs no
    weight grad: the patches dW is its own graph node."""
    calls = _Calls(monkeypatch)
    x = torch.randn((2, 6, 8, 8), requires_grad=True)
    w = torch.randn((3, 6, 5, 5), requires_grad=True)
    y = conv.conv2d(x, w, padding=2, alt_backward=True)
    torch.autograd.grad(y.sum(), x)
    assert calls.n["patches"] == 0
    torch.autograd.grad(conv.conv2d(x, w, padding=2, alt_backward=True).sum(), w)
    assert calls.n["patches"] == 1


def test_stage1_step_with_alt_backward_matches_jax(monkeypatch):
    """The port's stage-I 'vae-gan' step with ``alt_backward`` against the
    JAX step with ``alt_backward`` after steps 1 and 3 (``TOL``). At tiny
    the rewrites reach the six k5/p2/s2 convs (encoder 3, discriminator
    blocks 3: dx by phases) and the two stride-1 convs with at most 16
    output channels (the decoder's out conv, the discriminator's layer 0:
    dW by patches)."""
    calls = _Calls(monkeypatch)
    jcfg, cfg = (dataclasses.replace(c, model=dataclasses.replace(c.model, alt_backward=True))
                 for c in _configs("tiny"))
    groups = convert.random_groups(cfg, 0, "vae-gan")
    jstate, state = _jax_state(groups, jcfg), _port_state(groups, cfg)
    jfns, fns = jax_step(jcfg, donate=False), make_vgan_stage1_step(cfg)
    start = {k: v.clone() for k, v in state.nets.state_dict().items()}
    for i in range(3):
        x = _images(cfg, 8, 10 + i)
        key = jax.random.key(100 + i)
        eps, z_p = _noise(key, 8, cfg.model.latent_dim)
        jstate, jm = jfns.train_step(jstate, jnp.asarray(x), key, jnp.float32(MARGIN),
                                     jnp.float32(0.68), jnp.float32(LAMBDA_MSE))
        state, m = fns.train_step(state, torch.from_numpy(x), torch.from_numpy(eps),
                                  torch.from_numpy(z_p), MARGIN, 0.68, LAMBDA_MSE)
        if i in (0, 2):
            _compare(jstate, jm, state, m, cfg, start, TOL)
    assert calls.n["phases"] > 0 and calls.n["patches"] > 0
