"""The port's SSIM (fmri_tpu_torch/ops/ssim.py): the plain version against
the JAX package's XLA path and its Pallas kernel (interpret mode) on the
CPU, and the wrapper's CPU dispatch and shared-memory plan. The CUDA kernel
itself is held against the plain version in ``tests/test_torch_cuda.py``.

Tolerance: atol 1e-5 on the means, fp32 arithmetic on both sides with
different summation orders (separable vs 2-D window, reduction trees)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import uniform_pair

from fmri_tpu.metrics.quality import ssim as jax_ssim
from fmri_tpu.ops.pallas_ssim import ssim_pallas
from fmri_tpu_torch.ops import ssim as port

SIZES = [8, 16, 64, 100]


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("size", SIZES)
def test_plain_matches_jax_and_pallas(size, size_average):
    a, b = uniform_pair((2, size, size, 3), seed=size)
    got = port.ssim_plain(torch.from_numpy(a), torch.from_numpy(b),
                          size_average=size_average).numpy()
    xla = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b),
                              size_average=size_average))
    pallas = np.asarray(ssim_pallas(jnp.asarray(a), jnp.asarray(b),
                                    size_average=size_average, interpret=True))
    np.testing.assert_allclose(got, xla, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    a, b = uniform_pair((3, 16, 16, 3), seed=0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = port.ssim_plane_sums.launches
    assert torch.equal(port.ssim(ta, tb), port.ssim_plain(ta, tb))
    assert torch.equal(port.ssim(ta, tb, size_average=False),
                       port.ssim_plain(ta, tb, size_average=False))
    assert float(port.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-5)
    assert port.ssim_plane_sums.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    a = torch.zeros((1, 16, 16, 3))
    with pytest.raises(ValueError, match="CUDA"):
        port.ssim_plane_sums(a, a)


@pytest.mark.parametrize("size", SIZES)
def test_geometry_and_shared_memory_plan(size):
    k, pad, ho, wo = port.geometry(size, size)
    assert (k, pad) == (min(11, size), 5)
    assert ho == wo == size + 10 - (k - 1)  # 8 px -> an 11 x 11 map
    band_rows, bands, rows, smem = port.plan(size, size)
    assert 1 <= band_rows <= ho and (bands - 1) * band_rows < ho <= bands * band_rows
    assert rows == min(band_rows + k - 1, size)
    band_alloc = -(-band_rows // port.RUN) * port.RUN  # whole runs of rows
    f = ((band_alloc + k - 1) * (size | 1)       # staged planes, padding rows
         + band_alloc * ((size + 10) | 1))       # vertical output, pad columns
    assert smem == 16 * f + 4 * (-(-f // 4) * 4) + 4 * (2 * rows * size * 3
                                                       + port.WARPS * 3)
    # two blocks share an SM at every size the port runs (res100 included)
    assert smem <= port.SMEM_TWO_BLOCKS
    if size == 64:  # the inference run's shape: 4 bands of 16 output rows
        assert (band_rows, bands, rows) == (16, 4, 26)
    # the same function as the kernel's taps: the reference's window
    from fmri_tpu.metrics.quality import gaussian_window

    np.testing.assert_array_equal(port.gaussian_window(k), gaussian_window(k))


def test_plan_refuses_images_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        port.plan(4096, 4096)
    # a band of one output row still fits where two blocks do not
    band_rows, bands, rows, smem = port.plan(256, 256)
    assert port.SMEM_TWO_BLOCKS < smem <= port.SMEM_MAX and band_rows >= 1


def _walk(n, segments):
    """The items (i, s) each thread of csrc/ssim.cu's ``Walk`` takes, in its
    order: a start by one division, then steps of THREADS by carry."""
    per_thread = []
    for tid in range(port.THREADS):
        s, i = divmod(tid, n)
        ds, di = divmod(port.THREADS, n)
        items = []
        while s < segments:
            items.append((i, s))
            i, s = i + di, s + ds
            if i >= n:
                i, s = i - n, s + 1
        per_thread.append(items)
    return per_thread


def _run_pass(src, items, k, g):
    """One register-blocked blur pass as a thread runs it, for all its
    ``items`` (line, first input) at once: outputs o = 0 .. RUN - 1 read
    inputs u = o .. o + k - 1 of the zero-padded line, each input once,
    added into every output whose tap t = u - o lies in [0, k), taps in
    order. src is [5, lines, n]; returns [5, items, RUN]."""
    line = np.array([ln for ln, _ in items])
    first = np.array([f for _, f in items])
    acc = np.zeros((5, len(items), port.RUN))
    for u in range(port.RUN + k - 1):
        v = src[:, line, first + u]
        for o in range(port.RUN):
            if 0 <= u - o < k:
                acc[:, :, o] += g[u - o] * v
    return acc


def emulate_kernel(a, b):
    """[B, C, bands] plane-band sums as csrc/ssim.cu computes them, in
    float64, with ``hits`` counting how often each output pixel is scored."""
    nb, h, w, c = a.shape
    k, pad, ho, wo = port.geometry(h, w)
    band_rows, bands, raw_rows, _ = port.plan(h, w, c)
    g = port.gaussian_window(k)
    run = port.RUN
    band_alloc = -(-band_rows // run) * run
    rows, pv = band_alloc + k - 1, (w + 2 * pad) | 1
    out = np.zeros((nb, c, bands))
    hits = np.zeros((nb, c, ho, wo), dtype=int)
    for img in range(nb):
        for band in range(bands):
            r0 = band * band_rows
            r_end = min(r0 + band_rows, ho)
            n_out = r_end - r0
            ih_lo, ih_hi = max(0, r0 - pad), min(h, r_end - 1 - pad + k)
            n_in = max(0, ih_hi - ih_lo)
            ri_lo = ih_lo - (r0 - pad)
            assert n_in <= raw_rows
            # 1. the band's rows as they lie in memory: W * C floats each
            raw_x = a[img, ih_lo:ih_hi].reshape(n_in, w * c)
            raw_y = b[img, ih_lo:ih_hi].reshape(n_in, w * c)
            # staged planes: zeros off the image (and a run's spill rows
            # past the plane, which only discarded outputs read)
            prod = np.zeros((5, rows + run, w))
            # vertical output: pad columns zero, NaN until written
            vert = np.full((5, band_alloc, pv + run + k), np.nan)
            vert[:, :, :pad] = vert[:, :, pad + w:] = 0.0
            warp_sums = np.zeros((c, port.WARPS))
            vsegs, hsegs = -(-n_out // run), -(-wo // run)
            for ch in range(c):
                # 2. de-interleave (lane w, stride C) and form the products
                cols = np.arange(w) * c + ch
                x, y = raw_x[:, cols], raw_y[:, cols]
                prod[:, ri_lo:ri_lo + n_in] = np.stack([x, y, x * x, y * y, x * y])
                # 3. vertical pass: item (column i, segment s) makes output
                #    rows s * RUN + o from staged rows s * RUN + o + t
                items = [it for t in _walk(w, vsegs) for it in t]
                assert sorted(items) == [(i, s) for i in range(w) for s in range(vsegs)]
                acc = _run_pass(np.transpose(prod, (0, 2, 1)),  # [5, column, row]
                                [(i, s * run) for i, s in items], k, g)
                written = np.zeros((band_alloc, w), dtype=int)
                for n, (i, s) in enumerate(items):
                    vert[:, s * run:(s + 1) * run, pad + i] = acc[:, n]
                    written[s * run:(s + 1) * run, i] += 1
                assert (written[:n_out] == 1).all()  # every moment written once
                # 4. horizontal pass + SSIM from padded columns j0 + o + t,
                #    summed per thread in item order
                per_thread = np.zeros(port.THREADS)
                for tid, items in enumerate(_walk(n_out, hsegs)):
                    if not items:
                        continue
                    acc = _run_pass(vert, [(rr, s * run) for rr, s in items], k, g)
                    for n, (rr, s) in enumerate(items):
                        for o in range(run):
                            j = s * run + o
                            if j >= wo:
                                continue
                            mu1, mu2, exx, eyy, exy = acc[:, n, o]
                            assert np.isfinite(acc[:, n, o]).all()
                            s1, s2, s12 = exx - mu1 * mu1, eyy - mu2 * mu2, exy - mu1 * mu2
                            per_thread[tid] += (
                                (2 * mu1 * mu2 + port.C1) * (2 * s12 + port.C2)
                                / ((mu1 * mu1 + mu2 * mu2 + port.C1) * (s1 + s2 + port.C2)))
                            hits[img, ch, r0 + rr, j] += 1
                # warp shuffle tree (lane += lane + off), then warps in order
                lanes = per_thread.reshape(port.WARPS, 32).copy()
                for off in (16, 8, 4, 2, 1):
                    lanes[:, :32 - off] += lanes[:, off:].copy()
                warp_sums[ch] = lanes[:, 0]
            for ch in range(c):
                for wp in range(port.WARPS):
                    out[img, ch, band] += warp_sums[ch, wp]
    return out, hits


@pytest.mark.parametrize("size", SIZES)
def test_kernel_tiling_emulated_matches_plain(size):
    """The kernel's tiling in numpy (bands and their halo rows, all channels
    of a block, the zero padding in shared memory, the vertical pass over
    the staged rows and then the horizontal pass, the register runs of
    both, the walk of items over threads, the partial sums' order): every
    output pixel is scored once from written moments only,
    and the plane sums equal ``ssim_plain`` in float64 within 1e-12."""
    a, b = uniform_pair((2 if size <= 16 else 1, size, size, 3), seed=size + 1)
    a, b = a.astype(np.float64), b.astype(np.float64)
    sums, hits = emulate_kernel(a, b)
    assert (hits == 1).all()
    _, _, ho, wo = port.geometry(size, size)
    got = sums.sum(axis=(1, 2)) / (3 * ho * wo)
    ref = port.ssim_plain(torch.from_numpy(a), torch.from_numpy(b),
                          size_average=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
