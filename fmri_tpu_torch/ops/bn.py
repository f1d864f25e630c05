"""Train-mode BatchNorm: the forward with fp32 statistics, and the backward
through two hand-written CUDA kernels (``csrc/bn.cu``) or their plain
PyTorch versions.

Counterpart of ``fmri_tpu/ops/pallas_bn.py``:

* :func:`bn_bwd_reduce` (``bn_bwd_reduce`` :63): the ``[2, C]`` fp32 sums
  ``sum dy`` and ``sum dy * xhat`` in one pass over x and dy, with
  ``xhat = (x - mu) * inv`` recomputed.
* :func:`bn_bwd_apply` (``bn_bwd_apply`` :97):
  ``dx = gamma * inv / M * (M * dy - sum dy - xhat * sum dy*xhat)
  + a0 + a1 * xhat``, fp32.
* :class:`BatchNormTrain` (``batch_norm_train`` :140-196): returns
  ``(y, mu, biased var)``; its backward takes cotangents on all three and
  folds those of mu and var into ``a0 = ct_mu / M`` and
  ``a1 = 2 * ct_var / (M * inv)``. Given a mesh (``parallel/mesh.py``) it
  normalises with the global batch's statistics over the mesh's data
  group: the same two kernels, with one all-reduce of the reduce pass's
  sums between them and M the global count.

Tensors are ``[B, C, *spatial]`` (NCHW, or ``[N, C]``), reduced over every
axis but 1; M is the number of elements per channel. A CUDA tensor launches
the kernel (and adds one to ``<fn>.launches``) or raises; a CPU tensor takes
the ``*_plain`` version, which the CPU tests hold against the JAX kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256         # kThreads in csrc/bn.cu
TARGET_BLOCKS = 1056  # 8 blocks of 256 threads per SM on 132 SMs
MIN_CHUNK = 4096      # elements per reduce block, at least


def _bshape(x: torch.Tensor) -> list[int]:
    return [1, x.shape[1]] + [1] * (x.dim() - 2)


def _dims(x: torch.Tensor) -> list[int]:
    return [0] + list(range(2, x.dim()))


def _count(x: torch.Tensor) -> int:
    return x.numel() // x.shape[1]


def bn_bwd_reduce_plain(x: torch.Tensor, dy: torch.Tensor, mu: torch.Tensor,
                        inv: torch.Tensor) -> torch.Tensor:
    """[2, C] fp32: row 0 sum(dy), row 1 sum(dy * xhat)."""
    bs = _bshape(x)
    xhat = (x.float() - mu.view(bs)) * inv.view(bs)
    dyf = dy.float()
    return torch.stack([dyf.sum(_dims(x)), (dyf * xhat).sum(_dims(x))])


def bn_bwd_apply_plain(x: torch.Tensor, dy: torch.Tensor, mu: torch.Tensor,
                       inv: torch.Tensor, gamma: torch.Tensor,
                       sums: torch.Tensor, a0: torch.Tensor,
                       a1: torch.Tensor, count: int | None = None) -> torch.Tensor:
    """fp32 dx of the shape of x; ``count`` is M (default x's own count)."""
    bs = _bshape(x)
    m = count or _count(x)
    xhat = (x.float() - mu.view(bs)) * inv.view(bs)
    coef = (gamma * inv / m).view(bs)
    return (coef * (m * dy.float() - sums[0].view(bs) - xhat * sums[1].view(bs))
            + a0.view(bs) + a1.view(bs) * xhat)


def _check(x: torch.Tensor, dy: torch.Tensor, *vectors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a consistent set of operands; raises otherwise."""
    if x.dim() < 2:
        raise ValueError(f"x must be [B, C, ...], got {tuple(x.shape)}")
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and x {tuple(x.shape)} differ")
    devices = {t.device for t in (x, dy, *vectors)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    kind = x.device.type
    if kind == "cpu":
        return kind
    if kind != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in KERNEL_DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"x and dy must both be float32 or bfloat16, got "
                        f"{x.dtype} and {dy.dtype}")
    c = x.shape[1]
    for v in vectors:
        if v.dtype != torch.float32:
            raise TypeError(f"per-channel operands must be float32, got {v.dtype}")
        if v.shape[-1] != c or not v.is_contiguous():
            raise ValueError(f"per-channel operand {tuple(v.shape)} does not "
                             f"match C = {c} or is not contiguous")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous [B, C, ...]")
    return kind


@functools.cache
def _lib():
    """The built ``csrc/bn.cu``, typed for ctypes."""
    from fmri_tpu_torch.ops import build

    lib = build.load("bn")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bn_bwd_reduce.restype = i
    lib.bn_bwd_reduce.argtypes = [p] * 6 + [i, i, ll, ll, i, p]
    lib.bn_bwd_apply.restype = i
    lib.bn_bwd_apply.argtypes = [p] * 9 + [i, i, ll, ll, ctypes.c_float, i, i, i, i, p]
    return lib


def reduce_splits(c: int, m: int) -> int:
    """Blocks per channel of the reduce pass: enough blocks to fill the card,
    each with at least ``MIN_CHUNK`` elements."""
    return max(1, min(-(-TARGET_BLOCKS // c), -(-m // MIN_CHUNK)))


def bn_bwd_reduce(x: torch.Tensor, dy: torch.Tensor, mu: torch.Tensor,
                  inv: torch.Tensor) -> torch.Tensor:
    """[2, C] fp32 sums (dy, dy * xhat) over every axis but 1."""
    if _check(x, dy, mu, inv) == "cpu":
        return bn_bwd_reduce_plain(x, dy, mu, inv)
    c, m = x.shape[1], _count(x)
    s = m // x.shape[0] if x.shape[0] else 0
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    if m == 0 or c == 0:
        return sums.zero_()
    splits = reduce_splits(c, m)
    partial = torch.empty((c, splits, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().bn_bwd_reduce(x.data_ptr(), dy.data_ptr(), mu.data_ptr(),
                                  inv.data_ptr(), partial.data_ptr(),
                                  sums.data_ptr(), KERNEL_DTYPES[x.dtype], c, s,
                                  m, splits, stream)
    if rc != 0:
        raise RuntimeError(f"bn_bwd_reduce launch failed with CUDA error {rc} "
                           f"(shape {tuple(x.shape)}, {splits} splits)")
    bn_bwd_reduce.launches += 1
    return sums


bn_bwd_reduce.launches = 0


@functools.lru_cache(maxsize=256)
def apply_plan(c: int, s: int, runs: int, elem_bytes: int, aligned: bool):
    """(vector width, log2 threads per run, blocks_x, blocks_y) of the apply
    kernel over ``runs`` = B * C runs of S elements of ``elem_bytes`` each.
    Vectors are 16 bytes (4 fp32, 8 bf16) when x, dy and dx start on 16
    bytes. S > 1: a power-of-two row of threads per run, sized so each
    thread makes about four vectors, and at most ``TARGET_BLOCKS`` blocks
    striding over the runs (blocks_y = 1). S = 1: one thread per vector of
    channels (which needs C to be a multiple of the vector), blocks_y
    blocks striding over the N = runs / C rows."""
    full = 16 // elem_bytes
    if s == 1:
        vec = full if aligned and c % full == 0 else 1
        bx = -(-(c // vec) // THREADS)
        return vec, 0, bx, max(1, min(runs // c, TARGET_BLOCKS // bx))
    vec = full if aligned else 1
    per_thread = -(-(-(-s // vec)) // 4)
    log2 = min(8, max(0, (per_thread - 1).bit_length()))
    return vec, log2, max(1, min(-(-runs // (THREADS >> log2)), TARGET_BLOCKS)), 1


def bn_bwd_apply(x: torch.Tensor, dy: torch.Tensor, mu: torch.Tensor,
                 inv: torch.Tensor, gamma: torch.Tensor, sums: torch.Tensor,
                 a0: torch.Tensor, a1: torch.Tensor, count: int | None = None
                 ) -> torch.Tensor:
    """fp32 dx = gamma*inv/M * (M*dy - sum dy - xhat*sum dy*xhat) + a0 + a1*xhat,
    M = ``count`` (the global count under a mesh; default x's own)."""
    if _check(x, dy, mu, inv, gamma, sums, a0, a1) == "cpu":
        return bn_bwd_apply_plain(x, dy, mu, inv, gamma, sums, a0, a1, count)
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    total = x.numel()
    if total == 0:
        return dx
    c = x.shape[1]
    runs = x.shape[0] * c
    s = total // runs
    px, pd, po = x.data_ptr(), dy.data_ptr(), dx.data_ptr()
    aligned = (px | pd | po) % 16 == 0
    vec, log2, bx, by = apply_plan(c, s, runs, x.element_size(), aligned)
    with torch.cuda.device(x.device):
        rc = _lib().bn_bwd_apply(px, pd, mu.data_ptr(), inv.data_ptr(), gamma.data_ptr(),
                                 sums.data_ptr(), a0.data_ptr(), a1.data_ptr(), po,
                                 KERNEL_DTYPES[x.dtype], c, s, runs,
                                 float(count or total // c),
                                 int(vec > 1), log2, bx, by,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_bwd_apply launch failed with CUDA error {rc} "
                           f"(shape {tuple(x.shape)})")
    bn_bwd_apply.launches += 1
    return dx


bn_bwd_apply.launches = 0


class BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm over every axis but 1: ``(y, mu, var)`` with the
    biased batch variance. Statistics are fp32 whatever the input type (a
    bf16 reduction over ~1e6 elements would corrupt them), so y is fp32.

    The variance is two-pass, ``mean((x - mu)^2)``, as ``jnp.var`` in the JAX
    kernel's forward; torch's native BatchNorm uses Welford on CUDA and flax's
    stock path ``E[x^2] - E[x]^2``, so the three agree to fp32 rounding.

    ``mesh`` (a ``parallel.mesh.Mesh`` with a data axis over 1) makes the
    statistics the global batch's: mu the data group's all-reduced sum over
    the global count M, the variance an all-reduced sum of (x - mu)^2. The
    backward all-reduces the reduce pass's ``(sum dy, sum dy * xhat)``, with
    the cotangents of mu and var, between the two passes and applies with M
    global. dgamma and dbeta stay this rank's own sums: the step sums every
    weight gradient over the data group afterwards, and global ones would be
    counted D times. ``plain`` takes the plain versions of both passes (the
    FC BatchNorms and ``pallas_bn`` off under a mesh)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, mesh=None, plain: bool = False):
        bs, dims = _bshape(x), _dims(x)
        xf = x.float()
        if mesh is None:
            mu = xf.mean(dims)
            var = (xf - mu.view(bs)).square().mean(dims)
            m = _count(x)
        else:
            m = _count(x) * mesh.data
            mu = mesh.data_sum(xf.sum(dims)) / m
            var = mesh.data_sum((xf - mu.view(bs)).square().sum(dims)) / m
        inv = torch.rsqrt(var + eps)
        y = (xf - mu.view(bs)) * inv.view(bs) * gamma.view(bs) + beta.view(bs)
        ctx.save_for_backward(x, gamma, mu, inv)
        ctx.mesh, ctx.plain, ctx.m = mesh, plain, m
        ctx.set_materialize_grads(True)
        return y, mu, var

    @staticmethod
    def backward(ctx, dy, ct_mu, ct_var):
        x, gamma, mu, inv = ctx.saved_tensors
        m, mesh = ctx.m, ctx.mesh
        reduce, apply = ((bn_bwd_reduce_plain, bn_bwd_apply_plain) if ctx.plain
                         else (bn_bwd_reduce, bn_bwd_apply))
        x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
        local = reduce(x, dy, mu, inv)
        sums = local
        if mesh is not None:  # one all-reduce between the two passes
            packed = mesh.data_sum(torch.cat([local, ct_mu.float().view(1, -1),
                                              ct_var.float().view(1, -1)]))
            sums, ct_mu, ct_var = packed[:2].contiguous(), packed[2], packed[3]
        # d mu/dx = 1/M and d var/dx = 2 (x - mu) / M = 2 xhat / (inv M)
        a0 = (ct_mu / m).float().contiguous()
        a1 = (2.0 * ct_var / (m * inv)).float().contiguous()
        global_count = (m,) if mesh is not None else ()
        dx = apply(x, dy, mu, inv, gamma, sums, a0, a1, *global_count)
        return dx.to(x.dtype), local[1], local[0], None, None, None


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5, mesh=None, plain: bool = False):
    """``(y, mu, var)`` of train-mode BatchNorm; see :class:`BatchNormTrain`."""
    return BatchNormTrain.apply(x, gamma, beta, eps, mesh, plain)
