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
    tile, smem = port.plan(size, size)
    assert 1 <= tile <= min(32, ho)
    assert smem == 4 * (tile + k - 1) * (2 * (size + 10) + 5 * wo)
    assert smem <= port.SMEM_BUDGET
    # the same function as the kernel's taps: the reference's window
    from fmri_tpu.metrics.quality import gaussian_window

    np.testing.assert_array_equal(port.gaussian_window(k), gaussian_window(k))


def test_plan_refuses_images_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        port.plan(4096, 4096)
