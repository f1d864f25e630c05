"""The port's presets, conv geometry, nets and weight converter against the
JAX package, on the CPU.

Weights are seeded numpy trees in the JAX layout (``random_groups``, whose
tree is held against the flax init below), fed to the JAX modules as they
are and to the port through ``from_jax_groups``. fp32 tolerance: rtol 1e-4,
atol 1e-5 (conftest pins ``jax_default_matmul_precision=highest``; the two
sides sum in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import port_model

from fmri_tpu.checkpoints.torch_import import export_state_dict
from fmri_tpu.configs import presets as jax_presets
from fmri_tpu.models.nets import (
    CognitiveEncoder, Decoder, ImageDiscriminator, VisualEncoder,
)
from fmri_tpu.ops.conv import conv2d_transpose as jax_deconv
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.configs import presets
from fmri_tpu_torch.ops.conv import conv2d_transpose


def _forward_both(cfg, batch=2, seed=0):
    """(JAX mu, lv, image), (port mu, lv, image) from the same weights."""
    c = cfg.model
    groups = convert.random_groups(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    v = rng.normal(size=(batch, c.num_voxels)).astype(np.float32)
    enc, dec = groups["encoder"], groups["decoder"]
    mu, lv = CognitiveEncoder(c).apply(enc, jnp.asarray(v), train=False)
    img = Decoder(c).apply(dec, mu, train=False)
    model = port_model(groups, cfg)
    with torch.no_grad():
        tmu, tlv = model.encoder(torch.from_numpy(v))
        timg = model.decoder(tmu)
    return ([np.asarray(a) for a in (mu, lv, img)],
            [t.numpy() for t in (tmu, tlv, timg)])


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_presets_match_the_reference(name):
    assert (dataclasses.asdict(presets.get_config(name))
            == dataclasses.asdict(jax_presets.get_config(name)))
    got = presets.override_num_voxels(presets.get_config(name), 77)
    ref = jax_presets.override_num_voxels(jax_presets.get_config(name), 77)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("output_padding", [0, 1])
def test_deconv_geometry_and_taps(output_padding):
    """13 -> 25 (res100's first deconv, output_padding 0) and 13 -> 26."""
    rng = np.random.default_rng(output_padding)
    x = rng.normal(size=(2, 13, 13, 6)).astype(np.float32)
    k = rng.normal(size=(5, 5, 6, 4)).astype(np.float32)
    ref = np.asarray(jax_deconv(jnp.asarray(x), jnp.asarray(k), 2, 2, output_padding))
    got = conv2d_transpose(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(convert._inv_deconv(k)), 2, 2,
                           output_padding).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 25 + output_padding, 25 + output_padding, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("preset", ["tiny", "res64", "res100"])
def test_nets_match_jax(preset):
    ref, got = _forward_both(presets.get_config(preset))
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)


def test_res100_shapes():
    cfg = presets.get_config("res100")
    model = port_model(convert.random_groups(cfg, 0), cfg)
    with torch.no_grad():
        mu, lv = model.encoder(torch.zeros(2, cfg.model.num_voxels))
        img = model.decoder(mu)
    assert mu.shape == lv.shape == (2, 512)
    assert img.shape == (2, 100, 100, 3)
    assert bool(torch.isfinite(img).all())


def test_bf16_preset_within_bf16_noise():
    """bf16 conv/matmul operands on both sides, rounded at different places
    (the bias add, the accumulation order). bf16 keeps 8 significant bits,
    about 0.4% per rounding, and several roundings stack through the five
    layers: each output agrees within 2% of its largest magnitude (about
    1% measured on these weights)."""
    ref, got = _forward_both(presets.get_config("res64-bf16"))
    for r, g in zip(ref, got):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=2e-2 * np.abs(r).max())


def _flax_tree(module, *example):
    """{"params", "batch_stats"} of ``module``'s init as shape structs (no
    compile)."""
    return jax.eval_shape(
        lambda: module.init(jax.random.key(0), *example, train=True))


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), tree)


def test_random_groups_have_the_flax_tree():
    c = jax_presets.get_config("tiny").model
    ref = {"encoder": _flax_tree(CognitiveEncoder(c), jnp.zeros((2, c.num_voxels))),
           "decoder": _flax_tree(Decoder(c), jnp.zeros((2, c.latent_dim)))}
    got = convert.random_groups(presets.get_config("tiny"), 0)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)
    assert shapes(got) == shapes(ref)


def _exported(cfg, seed=0, teacher=False):
    """Port groups plus random discriminator (and teacher) groups, and the
    JAX package's export of all of them."""
    jcfg = jax_presets.get_config("tiny")
    c = jcfg.model
    img = jnp.zeros((2, c.image_size, c.image_size, 3))
    groups = dict(convert.random_groups(cfg, seed))
    groups["discriminator"] = _random_like(
        _flax_tree(ImageDiscriminator(c), img), seed + 1)
    if teacher:
        groups["teacher_encoder"] = _random_like(
            _flax_tree(VisualEncoder(c), img), seed + 2)
    return groups, export_state_dict(groups, jcfg, kind="vae-gan-cognitive")


def test_from_jax_groups_equals_export_state_dict():
    cfg = presets.get_config("tiny")
    groups, ref = _exported(cfg)
    got = convert.from_jax_groups(groups, cfg)
    ref = {k: v for k, v in ref.items() if k.startswith(("encoder.", "decoder."))}
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    port_model(groups, cfg)  # strict load


def test_load_pth_drops_discriminator_and_teacher(tmp_path):
    cfg = presets.get_config("tiny")
    groups, sd = _exported(cfg, teacher=True)
    assert any(k.startswith("teacher_net.") for k in sd)
    path = tmp_path / "model.pth"
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    loaded = convert.load_pth(str(path))
    assert all(k.startswith(("encoder.", "decoder.")) for k in loaded)
    model = port_model(groups, cfg)
    model.load_state_dict(loaded, strict=True)
    # a key the model does not have still fails the strict load
    path2 = tmp_path / "extra.pth"
    torch.save({**loaded, "encoder.extra": torch.zeros(1)}, path2)
    with pytest.raises(RuntimeError, match="extra"):
        model.load_state_dict(convert.load_pth(str(path2)), strict=True)
