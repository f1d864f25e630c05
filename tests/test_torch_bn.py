"""The port's train-mode BatchNorm (``fmri_tpu_torch/ops/bn.py``,
``fmri_tpu_torch/models/norm.py``) against the JAX package's Pallas
BatchNorm backward (``fmri_tpu/ops/pallas_bn.py``, run in interpret mode on
the CPU as its own tests run it) and ``fmri_tpu.models.norm.BatchNorm``.

On the CPU the wrappers take their plain versions, so these tests hold the
plain arithmetic that ``chip_smoke.py`` holds the CUDA kernels against.
Inputs come from numpy seeds. The port computes in [B, C, ...]; the JAX
kernels see [M, C] rows or NHWC, so [M, C] is passed to both as it is (the
port reads it as B = M images of one pixel) and NHWC is transposed.

Tolerances: fp32 sums over up to 1,500 rows in other orders, rtol 1e-5 and
atol 1e-4 (sums of magnitude ~30, so about 3 ulp); dx rtol 1e-5, atol 1e-6;
y/mu/var and their gradients rtol 2e-5, atol 2e-5 (both packages compute a
two-pass variance); the BatchNorm module's running statistics rtol 1e-5,
atol 1e-6 (flax's stock path uses E[x^2] - E[x]^2, torch a two-pass or
Welford variance); bf16 inputs give identical fp32 statistics on both sides
within 1e-5 and bf16 gradients within one bf16 step (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmri_tpu.models.norm import BatchNorm as JaxBatchNorm
from fmri_tpu.ops import pallas_bn
from fmri_tpu_torch.models.norm import BatchNorm2d
from fmri_tpu_torch.ops import bn


def _rows(m, c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, c)) * 2.0 + 0.5).astype(np.float32)
    dy = rng.normal(size=(m, c)).astype(np.float32)
    mu = x.mean(0).astype(np.float32)
    inv = (1.0 / np.sqrt(x.var(0) + 1e-5)).astype(np.float32)
    return x, dy, mu, inv


@pytest.mark.parametrize("m,c", [(64, 8), (1536, 64), (24, 3), (100, 16), (7, 5)])
def test_plain_reduce_and_apply_match_pallas(m, c):
    x, dy, mu, inv = _rows(m, c, seed=m + c)
    rng = np.random.default_rng(1)
    gamma, a0, a1 = rng.normal(size=(3, c)).astype(np.float32)
    if pallas_bn._row_tile(m, c, 2, 4) is None:
        pytest.skip("no Mosaic row tile for this [M, C] in the JAX kernel")
    ref = np.array(pallas_bn.bn_bwd_reduce(*map(jnp.asarray, (x, dy, mu, inv))))
    got = bn.bn_bwd_reduce(*map(torch.from_numpy, (x, dy, mu, inv)))
    assert got.dtype == torch.float32 and got.shape == (2, c)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    before = (bn.bn_bwd_reduce.launches, bn.bn_bwd_apply.launches)
    ref_dx = np.asarray(pallas_bn.bn_bwd_apply(
        *map(jnp.asarray, (x, dy, mu, inv, gamma, ref, a0, a1))))
    got_dx = bn.bn_bwd_apply(*map(torch.from_numpy, (x, dy, mu, inv, gamma, ref, a0, a1)))
    np.testing.assert_allclose(got_dx.numpy(), ref_dx, rtol=1e-5, atol=1e-6)
    # the CPU takes the plain version: no kernel launch is counted
    assert (bn.bn_bwd_reduce.launches, bn.bn_bwd_apply.launches) == before


def _nchw_case(shape, seed):
    """(x NHWC, gamma, beta, cotangents (dy NHWC, ct_mu, ct_var)) as numpy."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    cts = (rng.normal(size=shape).astype(np.float32),
           rng.normal(size=c).astype(np.float32),
           rng.normal(size=c).astype(np.float32))
    return x, gamma, beta, cts


def _to_nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


@pytest.mark.parametrize("shape", [(4, 6, 6, 8), (16, 4, 4, 8), (3, 5, 7, 2)])
def test_function_and_vjp_match_batch_norm_train(shape):
    """(y, mu, var) and the VJP with non-zero cotangents on all three
    outputs (mirrors tests/test_pallas_bn.py::test_mu_var_cotangents_flow)."""
    x, gamma, beta, (dy, ct_mu, ct_var) = _nchw_case(shape, seed=sum(shape))
    outs, vjp = jax.vjp(lambda a, g, b: pallas_bn.batch_norm_train(a, g, b, 1e-5),
                        *map(jnp.asarray, (x, gamma, beta)))
    ref_grads = vjp(tuple(map(jnp.asarray, (dy, ct_mu, ct_var))))
    tx = torch.from_numpy(_to_nchw(x)).requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    y, mu, var = bn.batch_norm_train(tx, tg, tb, 1e-5)
    for got, ref in zip((y, mu, var), outs):
        ref = np.asarray(ref)
        ref = _to_nchw(ref) if ref.ndim == 4 else ref
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=2e-5, atol=2e-5)
    grads = torch.autograd.grad(
        (y, mu, var), (tx, tg, tb),
        (torch.from_numpy(_to_nchw(dy)), torch.from_numpy(ct_mu),
         torch.from_numpy(ct_var)))
    for got, ref in zip(grads, ref_grads):
        ref = np.asarray(ref)
        ref = _to_nchw(ref) if ref.ndim == 4 else ref
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_function_matches_torch_autograd_with_only_dy():
    """Absent cotangents on (mu, var) arrive as zeros
    (``set_materialize_grads``): the gradient equals torch's own train-mode
    batch norm."""
    x, gamma, beta, (dy, _, _) = _nchw_case((5, 4, 3, 6), seed=3)
    x, dy = _to_nchw(x), _to_nchw(dy)
    args = [torch.from_numpy(a).double().requires_grad_() for a in (x, gamma, beta)]
    ref = torch.autograd.grad(torch.nn.functional.batch_norm(
        args[0], None, None, args[1], args[2], training=True, eps=1e-5),
        args, torch.from_numpy(dy).double())
    targs = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    y = bn.batch_norm_train(*targs)[0]
    got = torch.autograd.grad(y, targs, torch.from_numpy(dy))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pallas", [False, True])
def test_batchnorm_module_running_stats_match_jax(pallas):
    """Train-mode output and running statistics of the port's BatchNorm2d
    against ``fmri_tpu.models.norm.BatchNorm``, from non-trivial starting
    statistics, over two ticks: momentum 0.9 (new batch), the unbiased
    n/(n-1) running variance, the biased variance in the output."""
    shape = (6, 5, 5, 7)
    x, gamma, beta, _ = _nchw_case(shape, seed=11)
    rng = np.random.default_rng(12)
    mean0, var0 = rng.normal(size=7).astype(np.float32), rng.uniform(0.5, 2, 7).astype(np.float32)
    jmod = JaxBatchNorm(use_running_average=False, momentum=0.1, epsilon=1e-5,
                        pallas=pallas)
    variables = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    mod = BatchNorm2d(7, pallas=pallas)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(gamma))
        mod.bias.copy_(torch.from_numpy(beta))
        mod.running_mean.copy_(torch.from_numpy(mean0))
        mod.running_var.copy_(torch.from_numpy(var0))
    for tick in range(2):
        xt = x * (1.0 + tick)
        y_ref, upd = jmod.apply(variables, jnp.asarray(xt), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        y = mod(torch.from_numpy(_to_nchw(xt)))
        np.testing.assert_allclose(y.detach().numpy(), _to_nchw(np.asarray(y_ref)),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-6)
    assert int(mod.num_batches_tracked) == 2
    mod.eval()  # eval mode: the running statistics, either flag
    with torch.no_grad():
        y = mod(torch.from_numpy(_to_nchw(x)))
    y_ref = JaxBatchNorm(use_running_average=True, momentum=0.1, epsilon=1e-5,
                         pallas=pallas).apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), _to_nchw(np.asarray(y_ref)), rtol=1e-5,
                               atol=1e-5)


def test_saved_tensors_never_alias_running_stats():
    mod = BatchNorm2d(3, pallas=True)
    x = torch.randn(4, 3, 2, 2, requires_grad=True)
    y = mod(x)
    buffers = {mod.running_mean.data_ptr(), mod.running_var.data_ptr()}
    assert not buffers & {t.data_ptr() for t in y.grad_fn.saved_tensors}
    y.sum().backward()
    assert x.grad is not None and mod.weight.grad is not None


def test_bf16_input():
    """bf16 x: fp32 statistics and fp32 y; the backward casts dy to x's
    type before the reduction, as the JAX kernel does, and returns bf16 dx."""
    x, gamma, beta, (dy, ct_mu, ct_var) = _nchw_case((8, 4, 4, 6), seed=21)
    xb = jnp.asarray(x, jnp.bfloat16)
    outs, vjp = jax.vjp(lambda a, g, b: pallas_bn.batch_norm_train(a, g, b, 1e-5),
                        xb, jnp.asarray(gamma), jnp.asarray(beta))
    ref_dx, ref_dg, ref_db = vjp((jnp.asarray(dy), jnp.asarray(ct_mu),
                                  jnp.asarray(ct_var)))
    tx = torch.from_numpy(_to_nchw(np.asarray(xb.astype(jnp.float32)))).bfloat16()
    tx.requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    y, mu, var = bn.batch_norm_train(tx, tg, tb, 1e-5)
    assert y.dtype == mu.dtype == var.dtype == torch.float32
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(outs[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(outs[2]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), _to_nchw(np.asarray(outs[0])),
                               rtol=1e-5, atol=1e-5)
    dx, dg, db = torch.autograd.grad(
        (y, mu, var), (tx, tg, tb),
        (torch.from_numpy(_to_nchw(dy)), torch.from_numpy(ct_mu), torch.from_numpy(ct_var)))
    assert dx.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.float().numpy(),
                               _to_nchw(np.asarray(ref_dx.astype(jnp.float32))),
                               rtol=2**-8, atol=1e-3)
    np.testing.assert_allclose(dg.numpy(), np.asarray(ref_dg), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(db.numpy(), np.asarray(ref_db), rtol=1e-4, atol=1e-3)


def test_wrappers_check_their_operands():
    x = torch.zeros(4, 3, 2, 2)
    v = torch.zeros(3)
    with pytest.raises(ValueError, match="differ"):
        bn.bn_bwd_reduce(x, x[:2], v, v)
    with pytest.raises(ValueError, match=r"\[B, C"):
        bn.bn_bwd_reduce(v, v, v, v)
    assert bn.reduce_splits(64, 262144) * 64 >= bn.TARGET_BLOCKS
    assert bn.reduce_splits(256, 4096) == 1  # one block already covers a channel


def emulate_apply(x, dy, mu, inv, gamma, sums, a0, a1, elem_bytes):
    """dx as csrc/bn.cu's apply kernels write it, in numpy fp32 with the
    plain version's order of operations, and how often each element is
    written. The launch comes from ``bn.apply_plan`` with 16-byte aligned
    operands: runs of S elements (scalar head to the first 16-byte boundary,
    16-byte vectors, scalar tail) for S > 1, vectors of channels walking
    the rows for S = 1."""
    shape, c = x.shape, x.shape[1]
    runs = shape[0] * c
    s = x.size // runs
    vec, log2, bx, by = bn.apply_plan(c, s, runs, elem_bytes, True)
    full = 16 // elem_bytes
    assert vec == (1 if s == 1 and c % full else full)
    xf, df = x.reshape(-1).astype(np.float32), dy.reshape(-1).astype(np.float32)
    dx = np.zeros(x.size, np.float32)
    writes = np.zeros(x.size, int)
    m = np.float32(x.size // c)

    def put(at, ch):
        xhat = (xf[at] - mu[ch]) * inv[ch]
        coef = gamma[ch] * inv[ch] / m
        dx[at] = coef * (m * df[at] - sums[0, ch] - xhat * sums[1, ch]) + a0[ch] + a1[ch] * xhat
        writes[at] += 1

    if s == 1:
        for blk in range(bx):
            for t in range(bn.THREADS):
                c0 = (blk * bn.THREADS + t) * vec
                if c0 >= c:
                    continue
                for y in range(by):
                    for n in range(y, shape[0], by):
                        for q in range(vec):
                            put(n * c + c0 + q, c0 + q)
        return dx.reshape(shape), writes
    tpr, per_block = 1 << log2, bn.THREADS >> log2
    for blk in range(bx):
        for t in range(bn.THREADS):
            tx = t & (tpr - 1)
            for run in range(blk * per_block + (t >> log2), runs, bx * per_block):
                ch, start = run % c, run * s
                head = min(s, (vec - start % vec) % vec)
                nvec = (s - head) // vec
                body, end = start + head, start + s
                tail = body + nvec * vec
                for i in range(start + tx, body, tpr):
                    put(i, ch)
                for v in range(tx, nvec, tpr):
                    assert (body + v * vec) % vec == 0  # on a 16-byte boundary
                    for q in range(vec):
                        put(body + v * vec + q, ch)
                for i in range(tail + tx, end, tpr):
                    put(i, ch)
    return dx.reshape(shape), writes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 3, 8, 8), (5, 3, 7, 3), (3, 4, 5, 5),
                                   (2, 8, 16, 16), (7, 5), (6, 8), (9, 16)])
def test_apply_mapping_emulated_matches_plain(shape, dtype):
    """The apply kernels' mapping (runs per block, vector width, heads and
    tails for S that is not a multiple of the vector, the C axis for S = 1)
    writes every element once, each equal to ``bn_bwd_apply_plain``."""
    rng = np.random.default_rng(sum(shape))
    c = shape[1]
    x = torch.from_numpy((rng.normal(size=shape) * 2 + 0.5).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    dims = [0] + list(range(2, len(shape)))
    mu = x.float().mean(dims)
    inv = torch.rsqrt(x.float().var(dims, unbiased=False) + 1e-5)
    gamma, a0, a1 = torch.from_numpy(rng.normal(size=(3, c)).astype(np.float32))
    sums = bn.bn_bwd_reduce_plain(x, dy, mu, inv)
    ref = bn.bn_bwd_apply_plain(x, dy, mu, inv, gamma, sums, a0, a1).numpy()
    got, writes = emulate_apply(x.float().numpy(), dy.float().numpy(),
                                *(t.numpy() for t in (mu, inv, gamma, sums, a0, a1)),
                                x.element_size())
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, ref)
