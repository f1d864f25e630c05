"""The backbones of the ablations and the auxiliary losses against the JAX
package on the CPU: ``VoxelDecoder``, ``WaeDecoder`` and ``ResNetEncoder``
(``fmri_tpu_torch/models/nets.py``), the VGG19 ``features`` trunk
(``losses/vgg19.py``) and the ResNet-152 trunk (``models/resnet152.py``).

Modules: both packages hold the same seeded numpy weights
(``random_groups`` of the converter kinds ``"exp-decoder"``,
``"wae-decoder"``, ``"resnet-encoder"``; the port loads them through
``from_jax_groups``) and see the same inputs. One train-mode forward, the
gradient of ``sum(out * cot)`` for a fixed random cotangent, then one
RMSprop update (moments at ones, lr 1e-3) on both sides. Tolerances
(``TOL``): outputs atol 2e-5; the loss within 1e-5 of the sum of its
terms' sizes (a sum of terms of both signs); per parameter, the
L2 norm of the gradient's difference relative to the JAX gradient's (1e-4)
and of the updated weight's difference relative to the JAX update (1e-3);
BatchNorm running statistics relative to their norm (1e-5); ResNetEncoder's
gradients and updates 2e-3 (``RESNET_TOL`` says why). ResNetEncoder
steps at 32 and 17 px and runs its forward at 64 and 100 px, where Flax's
``'SAME'`` padding of a stride-2 conv pads one less at the top and left
than torch's symmetric ``padding`` would.

Trunks: one seeded npz in torchvision's layout (``vgg19.random_weights``,
``resnet152.random_weights``) read by both packages; VGG19 at taps 1-5 and
the trunk at layers (1, 1, 1, 1), rtol 2e-4 / atol 2e-4 as the JAX
package's own torch oracles (``tests/test_vgg19.py``,
``tests/test_resnet152.py``). The full (3, 8, 36, 3) trunk is checked for
its keys and output shape on the ``meta`` device, without running it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fmri_tpu.configs import presets as jax_presets
from fmri_tpu.losses import vgg19 as jax_vgg
from fmri_tpu.models import nets as jax_nets
from fmri_tpu.models import resnet152 as jax_r152
from fmri_tpu.train.optim import RmsProp as JaxRmsProp
from fmri_tpu.train.optim import RmsState
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.configs import presets
from fmri_tpu_torch.losses import vgg19
from fmri_tpu_torch.models import nets, resnet152
from fmri_tpu_torch.train.optim import RmsProp
from torch_port_helpers import one_torch_thread  # noqa: F401

TOL = dict(out=2e-5, loss=1e-5, grad=1e-4, param=1e-3, stats=1e-5)
# ResNetEncoder's gradients pass eleven train-mode BatchNorms at batch 3 (the
# last blocks over a few pixels, the head's over [3, 1024] and [3, 768]): in
# fp32 the port's gradients lie 3e-4 (L2, relative) from its own float64
# ones and the JAX package's further, so both run in float64, where they
# agree to 3e-8, the converter's fp32 rounding of the JAX side (running
# statistics of about 1 are held to 1e-7 for it)
TOL64 = dict(out=1e-9, loss=1e-12, grad=1e-6, param=1e-6, stats=1e-7)
LR = 1e-3


@pytest.fixture(autouse=True)
def _threads(one_torch_thread):
    yield


def _configs(**model):
    return tuple(dataclasses.replace(m.get_config("tiny"), model=dataclasses.replace(
        m.get_config("tiny").model, **model)) for m in (jax_presets, presets))


def _rel(got, ref, scale, floor=1e-30) -> float:
    return float((torch.as_tensor(np.asarray(got)).double()
                  - torch.as_tensor(np.asarray(ref)).double()).norm()
                 / max(float(torch.as_tensor(np.asarray(scale)).double().norm()), floor))


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _both_steps(jmod, mod, group, cfg, kind, x, prefix="", x64=False):
    """One train-mode forward, gradient and RMSprop update of the JAX module
    ``jmod`` over numpy ``group`` and of the port's ``mod`` loaded from it;
    compares every output, gradient, updated weight and BN statistic. With
    ``x64`` both sides run in float64 (``TOL64``); a gradient that is zero
    in exact arithmetic (an FC bias before a train-mode BatchNorm), and its
    update, are held to 1e-12 absolute."""
    name = kind_group(kind)
    mod.load_state_dict(_strip(convert.from_jax_groups({name: group}, cfg, kind), prefix),
                        strict=True)
    tol, dt, floor = (TOL64, np.float64, 1e-6) if x64 else (TOL, np.float32, 1e-30)
    if x64:
        mod.double()
        group = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), group)
        x = x.astype(dt)
    with jax.enable_x64(x64):
        _compare_step(jmod, mod, group, cfg, kind, x, prefix, tol, dt, floor)


def _compare_step(jmod, mod, group, cfg, kind, x, prefix, tol, dt, floor):
    name = kind_group(kind)
    params, stats = group["params"], group["batch_stats"]

    def apply(p):
        out, upd = jmod.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                              train=True, mutable=["batch_stats"])
        return (out if isinstance(out, tuple) else (out,)), upd

    rng = np.random.default_rng(7)
    cots = [rng.normal(size=o.shape).astype(dt) for o in jax.eval_shape(apply, params)[0]]

    def jloss(p):
        outs, upd = apply(p)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, upd)

    (jl, (jouts, upd)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    opt_j = JaxRmsProp(0.9, 1e-8)
    jnew = jax.jit(lambda g, p: opt_j.update(
        g, RmsState(jax.tree_util.tree_map(jnp.ones_like, p)), p, jnp.asarray(LR, dt),
        1.0)[0])(jg, params)

    mod.train()
    outs = mod(torch.from_numpy(x))
    outs = outs if isinstance(outs, tuple) else (outs,)
    terms = [o * torch.from_numpy(c) for o, c in zip(outs, cots)]
    loss = sum(torch.sum(t) for t in terms)
    named = dict(mod.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    start = {k: v.detach().clone() for k, v in named.items()}
    RmsProp(0.9, 1e-8).update(grads, {k: torch.ones_like(v) for k, v in named.items()},
                              named, torch.tensor(LR, dtype=torch.float64 if dt == np.float64
                                                  else torch.float32))

    # the loss sums terms of both signs: its scale is the sum of their sizes
    scale = sum(float(torch.sum(torch.abs(t.detach()))) for t in terms)
    assert abs(float(loss.detach()) - float(jl)) <= tol["loss"] * scale
    for got, ref in zip(outs, jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol["out"])
    # gradients and updates through the converter's permutations (in fp32)
    ref_g, ref_d = (convert.moments_from_jax({name: t}, cfg, kind)[name] for t in (
        jg, jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), jnew, params)))
    assert sorted(ref_g) == sorted(grads)
    for k, g in grads.items():
        assert _rel(g, ref_g[k], ref_g[k], floor) <= tol["grad"], k
        assert _rel(named[k].detach() - start[k], ref_d[k], ref_d[k],
                    floor) <= tol["param"], k
    ref_s = _strip(convert.from_jax_groups(
        {name: {"params": jnew, "batch_stats": upd["batch_stats"]}}, cfg, kind), prefix)
    sd = mod.state_dict()
    for k, v in ref_s.items():
        if "running" in k:
            assert _rel(sd[k], v, v) <= tol["stats"], k


def kind_group(kind):
    return "encoder" if kind == "resnet-encoder" else "decoder"


@pytest.mark.parametrize("fc_input,pad", [(8, (True, True, True)),
                                          (2, (False, True, False))],
                         ids=["64px", "odd-9px"])
def test_voxel_decoder_matches_jax(fc_input, pad):
    """VoxelDecoder: the decoder's blocks over an FC from the voxels with
    tanh (64 px from an 8 px FC; 9 px with output padding off in two
    blocks)."""
    jcfg, cfg = _configs(fc_input=fc_input, output_pad_dec=pad)
    group = convert.random_groups(cfg, 0, "exp-decoder")["decoder"]
    x = np.random.default_rng(1).normal(size=(4, cfg.model.num_voxels)).astype(np.float32)
    _both_steps(jax_nets.VoxelDecoder(jcfg.model), nets.VoxelDecoder(cfg.model), group,
                cfg, "exp-decoder", x, prefix="decoder.")


def test_voxel_decoder_takes_the_kernel_flags():
    """With ``pallas_bn`` and ``pallas_backward`` the port's VoxelDecoder
    gives the flags-off gradients (CPU: the kernels' plain versions)."""
    _, cfg = _configs()
    _, cfg_on = _configs(pallas_bn=True, pallas_backward=True)
    sd = _strip(convert.from_jax_groups(convert.random_groups(cfg, 3, "exp-decoder"), cfg,
                                        "exp-decoder"), "decoder.")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, cfg.model.num_voxels)).astype(np.float32))
    out = []
    for c in (cfg, cfg_on):
        m = nets.VoxelDecoder(c.model)
        m.load_state_dict(sd, strict=True)
        y = m(x)
        out.append(torch.autograd.grad(y.square().sum(), list(m.parameters())))
    for a, b in zip(*out):
        assert _rel(a, b, b) <= 1e-5


def test_wae_decoder_matches_jax():
    """WaeDecoder: 1024-channel FC, blocks 1024 -> 512 -> 256 -> 128."""
    jcfg, cfg = _configs()
    group = convert.random_groups(cfg, 1, "wae-decoder")["decoder"]
    z = np.random.default_rng(3).normal(size=(3, cfg.model.latent_dim)).astype(np.float32)
    _both_steps(jax_nets.WaeDecoder(jcfg.model), nets.WaeDecoder(cfg.model), group, cfg,
                "wae-decoder", z)


@pytest.mark.parametrize("size", [16, 17])
def test_resnet_encoder_matches_jax(size):
    """ResNetEncoder's compact trunk and head in train mode, in float64:
    stride-2 SAME padding at an even and an odd size."""
    jcfg, cfg = _configs()
    group = convert.random_groups(cfg, 2, "resnet-encoder")["encoder"]
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    _both_steps(jax_nets.ResNetEncoder(jcfg.model), nets.ResNetEncoder(cfg.model), group,
                cfg, "resnet-encoder", x, x64=True)


@pytest.mark.parametrize("size", [64, 100])
def test_resnet_encoder_forward(size):
    """The fp32 eval-mode forward at 64 and 100 px (the latter's trunk passes
    25 and 13 px, odd sizes under stride 2), atol 2e-5. Eval mode: a
    train-mode BatchNorm over a batch this small turns rounding into
    differences of 1e-4."""
    jcfg, cfg = _configs()
    group = convert.random_groups(cfg, 2, "resnet-encoder")["encoder"]
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jmod = jax_nets.ResNetEncoder(jcfg.model)
    ref = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(group, jnp.asarray(x))
    mod = nets.ResNetEncoder(cfg.model)
    mod.load_state_dict(convert.from_jax_groups({"encoder": group}, cfg, "resnet-encoder"))
    mod.eval()
    for got, r in zip(mod(torch.from_numpy(x)), ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(r), atol=TOL["out"])


def test_same_padding_is_flax():
    """A centre-tap 7x7 stride-2 kernel reads input (2i, 2j) under SAME
    padding: one less on the top and left than torch's padding=3."""
    x = torch.arange(64.0).view(1, 1, 8, 8)
    w = torch.zeros(1, 1, 7, 7)
    w[0, 0, 3, 3] = 1.0
    got = nets._same_conv(x, w, 2)
    assert torch.equal(got[0, 0], x[0, 0, 1::2, 1::2])
    assert not torch.equal(got, torch.nn.functional.conv2d(x, w, stride=2, padding=3))


# ------------------------------------------------------------------ trunks


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vgg") / "vgg19_features.npz")
    np.savez(path, **{f"features.{k}": v for k, v in vgg19.random_weights(0).items()},
             **{"classifier.0.weight": np.zeros((2, 2), np.float32)})
    return path


def test_vgg19_taps_match_jax(vgg_npz):
    """Every tap of the reference's five, on one npz (whole-model keys with
    ``features.`` and a ``classifier`` key, which both loaders drop)."""
    params = jax_vgg.load_vgg19_npz.__wrapped__(vgg_npz)
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    for depth, upto in vgg19.TAPS.items():
        ref = np.asarray(jax_vgg.vgg19_features(params, jnp.asarray(x), upto))
        got = vgg19.vgg19_tap_fn(depth, vgg_npz)(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4, err_msg=str(depth))
    model = vgg19.load_model(vgg_npz, torch.device("cpu"))
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="FMRI_TPU_VGG19_NPZ"):
        vgg19.vgg19_tap_fn(1)


def test_resnet_trunk_matches_jax(tmp_path):
    """The trunk at layers (1, 1, 1, 1) on one torchvision-layout npz; its
    weights are buffers outside any state dict; the encoder over it."""
    layers = (1, 1, 1, 1)
    path = str(tmp_path / "resnet.npz")
    np.savez(path, **resnet152.random_weights(0, layers))
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    params = jax_r152.load_resnet152_npz.__wrapped__(path)
    ref = np.asarray(jax.jit(lambda a: jax_r152.resnet_trunk(params, a, layers))(
        jnp.asarray(x)))
    trunk = resnet152.resnet152_trunk_fn(path, layers)
    got = trunk(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    assert trunk.state_dict() == {} and not list(trunk.parameters())

    # ResNetEncoder over the trunk: the head's BatchNorms are BatchNorm_0/_1
    jcfg, cfg = _configs()
    jenc = jax_nets.ResNetEncoder(jcfg.model,
                                  trunk_fn=jax_r152.resnet152_trunk_fn(path, layers))
    full = convert.random_groups(cfg, 4, "resnet-encoder")["encoder"]
    rename = {"BatchNorm_1": "BatchNorm_0", "BatchNorm_2": "BatchNorm_1"}
    v = {"params": {**{k: v for k, v in full["params"].items() if k.startswith("Dense")},
                    **{new: full["params"][old] for old, new in rename.items()}},
         "batch_stats": {new: full["batch_stats"][old] for old, new in rename.items()}}
    v["params"]["Dense_0"] = {"kernel": np.random.default_rng(5).normal(
        0, 0.02, (2048, 1024)).astype(np.float32), "bias": v["params"]["Dense_0"]["bias"]}
    enc = nets.ResNetEncoder(cfg.model, trunk=trunk)
    enc.load_state_dict(convert.from_jax_groups({"encoder": v}, cfg, "resnet-encoder"),
                        strict=True)
    enc.eval()
    jmu, jlv = jax.jit(lambda a: jenc.apply(v, a, train=False))(jnp.asarray(x))
    mu, lv = enc(torch.from_numpy(x))
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lv.detach().numpy(), np.asarray(jlv), rtol=2e-4, atol=2e-4)


class _TvBottleneck(nn.Module):
    def __init__(self, cin, planes, stride, down):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(cin, planes, 1, bias=False), nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        if down:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                                            nn.BatchNorm2d(planes * 4))


class _TvResNet(nn.Module):
    """torchvision's ``resnet152`` module tree (names and shapes only)."""

    def __init__(self, layers):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64)
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            blocks = []
            for b in range(n):
                stride = 2 if b == 0 and li > 1 else 1
                blocks.append(_TvBottleneck(cin, planes, stride,
                                            b == 0 and (stride != 1 or cin != planes * 4)))
                cin = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.fc = nn.Linear(2048, 1000)


def test_full_resnet152_keys_and_shape():
    """Every key of torchvision's full-depth state dict but ``fc.*`` and
    ``num_batches_tracked`` is a buffer of the trunk, with its shape, and the
    trunk emits the 2048-d feature; on the meta device, nothing computed."""
    with torch.device("meta"):
        ref = _TvResNet(resnet152.RESNET152_LAYERS).state_dict()
        trunk = resnet152.ResNetTrunk()
        out = trunk(torch.empty(1, 64, 64, 3))
    want = {k: tuple(v.shape) for k, v in ref.items()
            if not (k.startswith("fc.") or k.endswith("num_batches_tracked"))}
    assert {k: tuple(v.shape) for k, v in trunk.named_buffers()} == want
    assert tuple(out.shape) == (1, 2048) and trunk.out_features == 2048
