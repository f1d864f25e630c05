"""The port's ``ServingModel`` for the ``wae`` kinds (stage I image ->
image, stages II and III fMRI -> image) and ``wae-vgan`` (image -> image at
any stage) against the JAX ``ServingModel`` on the CPU, with ``sample``
ignored by the WAE modules, which always decode the mean latent.

Both packages hold the same seeded random groups at ``tiny``; each JAX
model compiles one bucket. Tolerances: float images 1e-5 (fp32 both sides,
different convolution and summation orders); uint8 images 1 LSB (a value
at a rounding boundary may round either way).
"""

import numpy as np
import pytest
from torch_port_helpers import jax_decode, serve_requests, serving_pair

from fmri_tpu_torch.eval.steps import VaeGanVisual, WaeCognitive, WaeVisual

TOL = 1e-5
KINDS = [("wae", 1), ("wae", 2), ("wae", 3), ("wae-vgan", 1), ("wae-vgan", 3)]
MODULES = {"wae": {1: WaeVisual, 2: WaeCognitive, 3: WaeCognitive},
           "wae-vgan": {1: VaeGanVisual, 3: VaeGanVisual}}


@pytest.mark.parametrize("family,stage", KINDS)
def test_reconstruct_matches_jax(family, stage):
    port, ref, _ = serving_pair(family, stage, seed=10 + stage)
    assert type(port.model) is MODULES[family][stage]
    assert port.data_kind == ref.data_kind
    assert port.data_kind == ("pair" if family == "wae" and stage > 1 else "image")
    assert port.sample_shape() == ref.sample_shape()
    x = serve_requests(port, 11, seed=stage)
    np.testing.assert_allclose(port.reconstruct(x), ref.reconstruct(x), atol=TOL)
    one = port.reconstruct(x[4])
    np.testing.assert_allclose(one, ref.reconstruct(x[4]), atol=TOL)


@pytest.mark.parametrize("family,stage", [("wae", 1), ("wae", 3)])
def test_uint8_matches_jax(family, stage):
    port, ref, _ = serving_pair(family, stage, seed=20 + stage, output="uint8")
    x = serve_requests(port, 5, seed=stage)
    got, want = port.reconstruct(x), ref.reconstruct(x)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (5, 16, 16, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("family,stage", [("wae", 1), ("wae", 2)])
def test_sample_is_ignored_by_the_wae_modules(family, stage):
    """With ``sample=True`` the WAE modules still decode mu: the same images
    as without, and as the JAX model's with its reparameterization key."""
    sampled, ref, _ = serving_pair(family, stage, seed=30, sample=True)
    x = serve_requests(sampled, 5, seed=6)
    first = sampled.reconstruct(x)
    np.testing.assert_array_equal(sampled.reconstruct(x), first)
    plain, _, _ = serving_pair(family, stage, seed=30)
    np.testing.assert_array_equal(plain.reconstruct(x), first)
    np.testing.assert_allclose(ref.reconstruct(x), first, atol=TOL)


def test_wae_vgan_samples():
    """WAE/Dual-GAN's eval module is the VAE/GAN one: ``sample`` draws eps."""
    port, _, _ = serving_pair("wae-vgan", 1, seed=40, sample=True)
    x = serve_requests(port, 3, seed=7)
    assert np.abs(port.reconstruct(x) - port.reconstruct(x)).max() > 0


def test_generate_is_the_decoder_on_the_generators_draws():
    import torch

    port, _, groups = serving_pair("wae", 3, seed=50, max_batch=4)
    out = port.generate(3)
    g = torch.Generator().manual_seed(0x5EED)
    z = torch.randn((4, port.cfg.model.latent_dim), generator=g).numpy()
    np.testing.assert_allclose(out, jax_decode(groups, z)[:3], atol=TOL)
