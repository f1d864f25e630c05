"""The port's ``ServingModel`` for the ``vgan`` kinds (stage I image ->
image, stages II and III fMRI -> image) against the JAX ``ServingModel``
on the CPU, and its bucketing, padding, chunking, image-kind shapes,
prior sampling and seeded streams (the counterparts of
``tests/test_serve.py``'s model tests).

Both packages hold the same seeded random groups at ``tiny``; each JAX
model compiles one bucket (``min_bucket == max_batch``). Tolerances: float
images 1e-5 (fp32 both sides, different convolution and summation orders);
uint8 images 1 LSB (a value at a rounding boundary may round either way);
padded batch vs alone 1e-5 (the same model, another batch shape).
"""

import numpy as np
import pytest
import torch
from torch_port_helpers import jax_decode, serve_requests, serving_pair

from fmri_tpu.eval.serve import batch_buckets as jax_buckets
from fmri_tpu_torch.eval.serve import ServingModel, batch_buckets

TOL = 1e-5


def test_batch_buckets_match_jax():
    for args in [(1,), (8,), (12,), (64,), (8, 2), (8, 8), (64, 3)]:
        assert batch_buckets(*args) == jax_buckets(*args)
    assert batch_buckets(64) == [1, 2, 4, 8, 16, 32, 64]
    with pytest.raises(ValueError):
        batch_buckets(0)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_reconstruct_matches_jax(stage):
    """11 requests: the port chunks 8 + (3 -> bucket 4), the JAX model pads
    both chunks to its one bucket of 8; padding is exact on both sides."""
    port, ref, _ = serving_pair("vgan", stage, seed=stage)
    assert (port.family, port.stage) == ("vgan", stage)
    assert port.data_kind == ref.data_kind == ("image" if stage == 1 else "pair")
    assert port.sample_shape() == ref.sample_shape()
    x = serve_requests(port, 11, seed=stage)
    got, want = port.reconstruct(x), ref.reconstruct(x)
    assert got.shape == (11, 16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL)

    u8, ref8, _ = serving_pair("vgan", stage, seed=stage, output="uint8")
    got, want = u8.reconstruct(x), ref8.reconstruct(x)
    assert got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def cognitive():
    port, _, groups = serving_pair("vgan", 3, seed=7)
    return port, groups


def test_padding_is_exact_and_single_matches_batch(cognitive):
    model, _ = cognitive
    x = serve_requests(model, 3, seed=1)
    batched = model.reconstruct(x)                     # bucket 4, one pad row
    alone = np.stack([model.reconstruct(x[i]) for i in range(3)])
    assert alone.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(batched, alone, atol=TOL)


def test_chunking_past_max_batch(cognitive):
    model, _ = cognitive
    x = serve_requests(model, 19, seed=2)               # 8 + 8 + (3 -> 4)
    out = model.reconstruct(x)
    assert out.shape == (19, 16, 16, 3)
    assert 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out[8:16], model.reconstruct(x[8:16]), atol=TOL)
    np.testing.assert_allclose(out[16:], model.reconstruct(x[16:]), atol=TOL)


def test_empty_batch_and_bad_shapes(cognitive):
    model, _ = cognitive
    out = model.reconstruct(np.zeros((0, *model.sample_shape()), np.float32))
    assert out.shape == (0, 16, 16, 3) and out.dtype == np.float32
    with pytest.raises(ValueError, match="expected"):
        model.reconstruct(np.zeros((2, 7), np.float32))
    with pytest.raises(ValueError):
        model.generate(0)


def test_image_kind_input_shapes():
    port, _, _ = serving_pair("vgan", 1, seed=4, max_batch=4)
    assert port.sample_shape() == (16, 16, 3)
    x = serve_requests(port, 3, seed=3)
    one = port.reconstruct(x[1])
    assert one.shape == (16, 16, 3)
    np.testing.assert_allclose(one, port.reconstruct(x)[1], atol=TOL)
    with pytest.raises(ValueError, match="expected"):
        port.reconstruct(np.zeros((2, port.cfg.model.num_voxels), np.float32))
    with pytest.raises(ValueError, match="expected"):
        port.reconstruct(np.zeros((2, 8, 8, 3), np.float32))


def test_generate_is_the_decoder_on_the_generators_draws(cognitive):
    """generate(11) draws z from the server's generator (seed + 0x5EED) for
    bucket 8, then bucket 4 (3 rows kept): the JAX decoder on those draws."""
    model, groups = cognitive
    fresh = ServingModel(model.cfg, model.model, max_batch=8, seed=0, device="cpu")
    out = fresh.generate(11)
    g = torch.Generator().manual_seed(0x5EED)
    latent = model.cfg.model.latent_dim
    z = [torch.randn((b, latent), generator=g).numpy() for b in (8, 4)]
    want = np.concatenate([jax_decode(groups, z[0]), jax_decode(groups, z[1])[:3]])
    assert out.shape == (11, 16, 16, 3)
    np.testing.assert_allclose(out, want, atol=TOL)
    assert np.abs(fresh.generate(3) - out[:3]).max() > 0   # fresh z each call


def test_sampling_is_seeded_and_warmup_keeps_the_streams(cognitive):
    model, _ = cognitive

    def make(seed):
        return ServingModel(model.cfg, model.model, max_batch=8, sample=True,
                            seed=seed, device="cpu")

    x = serve_requests(model, 5, seed=5)
    fresh, warmed, other = make(3), make(3), make(4)
    warmed.warmup()
    assert warmed.graphs == 0                        # eager on the CPU
    a = fresh.reconstruct(x)
    np.testing.assert_array_equal(warmed.reconstruct(x), a)
    assert np.abs(fresh.reconstruct(x) - a).max() > 0   # fresh eps each call
    assert np.abs(other.reconstruct(x) - a).max() > 0
    np.testing.assert_array_equal(warmed.generate(3), make(3).generate(3))
    # the mean latent, without sample
    np.testing.assert_array_equal(model.reconstruct(x), model.reconstruct(x))


def test_family_and_stage_must_fit_the_module(cognitive):
    model, _ = cognitive
    with pytest.raises(TypeError, match="VaeGanVisual"):
        ServingModel(model.cfg, model.model, family="vgan", stage=1, device="cpu")
    with pytest.raises(ValueError, match="output"):
        ServingModel(model.cfg, model.model, output="int8", device="cpu")
    with pytest.raises(ValueError, match="family"):
        ServingModel(model.cfg, model.model, family="exp", device="cpu")
