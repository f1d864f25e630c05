"""The port's stage-I modes ``'vae'``, ``'beta-vae'`` and ``'dcgan'``, the
fused decoder batch and its ``vsplit`` BatchNorm, the ``alt_backward``
routing of every net and step factory and the ``--stage 1`` inference CLI,
against the JAX package on the CPU at ``tiny``.

Weights, data and the injected eps / z_p are made as in
``tests/test_torch_train.py``, whose helpers these tests share. Tolerances:
the stage-I steps as there (fp32 rounding at tiny: losses 1e-6 relative,
parameter movement 1e-3, statistics and moments 1e-5); ``vsplit``
BatchNorm within 1e-5 of two sequential calls (its variance is
E[x^2] - mean^2, torch's sequential calls take a two-pass variance) and
within 1e-5 of the JAX ``BatchNorm(vsplit=2)``, which uses the same
formula; the fused step within 1e-6 of the sequential one; the CLI's
metrics within 1e-5 of the JAX eval step's and its n-way fractions within
1/N.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (
    LAMBDA_MSE, MARGIN, _compare, _configs, _images, _jax_state, _noise, _port_nets,
    _port_state,
)
from torch_port_helpers import jax_state

from fmri_tpu.checkpoints.torch_import import export_state_dict
from fmri_tpu.data.synthetic import synthetic_images
from fmri_tpu.eval import evaluate as jax_eval
from fmri_tpu.models.norm import BatchNorm as JaxBatchNorm
from fmri_tpu.train import make_vgan_stage1_step as jax_step
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.eval import inference
from fmri_tpu_torch.eval.steps import VaeGanCognitive, VaeGanVisual
from fmri_tpu_torch.models import nets
from fmri_tpu_torch.models.norm import BatchNorm1d, BatchNorm2d
from fmri_tpu_torch.ops import conv_alt
from fmri_tpu_torch.train.state import GROUPS, VaeGan, VaeGanCognitiveTrain
from fmri_tpu_torch.train.steps_vgan import (
    make_vgan_cognitive_step, make_vgan_stage1_step,
)

TOL = dict(loss=1e-6, param=1e-3, stats=1e-5, sq=1e-5)


def _with(cfgs, **kw):
    return tuple(dataclasses.replace(c, model=dataclasses.replace(c.model, **kw))
                 for c in cfgs)


def _run_stage1(jcfg, cfg, mode, steps=3, b=8, check=(0, 2)):
    """Both packages' stage-I step in ``mode`` from one state; compares
    after the steps in ``check``. Returns (port state, start state dict)."""
    groups = convert.random_groups(cfg, 0, "vae-gan")
    jstate, state = _jax_state(groups, jcfg), _port_state(groups, cfg)
    jfns, fns = jax_step(jcfg, mode, donate=False), make_vgan_stage1_step(cfg, mode)
    start = {k: v.clone() for k, v in state.nets.state_dict().items()}
    sq0 = copy.deepcopy(state.opt_state)
    for i in range(steps):
        x = _images(cfg, b, 10 + i)
        key = jax.random.key(100 + i)
        eps, z_p = _noise(key, b, cfg.model.latent_dim)
        jstate, jm = jfns.train_step(jstate, jnp.asarray(x), key, jnp.float32(MARGIN),
                                     jnp.float32(0.68), jnp.float32(LAMBDA_MSE))
        state, m = fns.train_step(state, torch.from_numpy(x), torch.from_numpy(eps),
                                  torch.from_numpy(z_p), MARGIN, 0.68, LAMBDA_MSE)
        assert (float(m["train_dec"]), float(m["train_dis"])) == (
            float(jm["train_dec"]), float(jm["train_dis"]))
        if i in check:
            _compare(jstate, jm, state, m, cfg, start, TOL)
    return state, start, sq0


@pytest.mark.parametrize("flags", [False, True], ids=["flags-off", "kernels"])
@pytest.mark.parametrize("mode", ["vae", "beta-vae", "dcgan"])
def test_stage1_mode_matches_jax(mode, flags):
    """Metrics, gates, parameters, BN statistics and moments after steps 1
    and 3. 'dcgan' freezes the encoder: its parameters and RMSprop moments
    stay bitwise, its BatchNorm statistics still tick."""
    jcfg, cfg = _configs("tiny", flags)
    state, start, sq0 = _run_stage1(jcfg, cfg, mode)
    sd = state.nets.state_dict()
    frozen = mode == "dcgan"
    for k, v in sd.items():
        if k.startswith("encoder.") and "running" not in k and "num_batches" not in k:
            assert torch.equal(v, start[k]) == frozen, k
    for k, v in state.opt_state["encoder"].items():
        assert torch.equal(v, sq0["encoder"][k]) == frozen, k
    assert not torch.equal(sd["encoder.fc.1.running_mean"], start["encoder.fc.1.running_mean"])


def test_unknown_mode_and_backward_raise():
    cfg = _configs("tiny")[1]
    for make in (make_vgan_stage1_step, lambda c, m: make_vgan_cognitive_step(c, 3, m)):
        with pytest.raises(ValueError, match="unknown mode"):
            make(cfg, "gan")
    with pytest.raises(ValueError, match="backward"):
        make_vgan_stage1_step(cfg, backward="adjoint")


@pytest.mark.parametrize("pallas_backward", [False, True])
def test_fused_stage1_step(pallas_backward):
    """``fused_decoder_batch``: one vsplit=2 decode of [z, z_p] gives the
    two sequential decodes' update (atol 1e-6) and the JAX fused step's
    (``pallas_bn`` off: vsplit forbids it)."""
    cfgs = _with(_configs("tiny", False), pallas_backward=pallas_backward)
    jcfg, cfg = _with(cfgs, fused_decoder_batch=True)
    fused, _, _ = _run_stage1(jcfg, cfg, "vae-gan")
    groups = convert.random_groups(cfg, 0, "vae-gan")
    seq = _port_state(groups, cfgs[1])
    step = make_vgan_stage1_step(cfgs[1])
    for i in range(3):
        eps, z_p = _noise(jax.random.key(100 + i), 8, 16)
        seq, _ = step.train_step(seq, torch.from_numpy(_images(cfg, 8, 10 + i)),
                                 torch.from_numpy(eps), torch.from_numpy(z_p),
                                 MARGIN, 0.68, LAMBDA_MSE)
    ref = seq.nets.state_dict()
    for k, v in fused.nets.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("shape", [(6, 5, 4, 3), (6, 7)], ids=["2d", "1d"])
def test_vsplit_batch_norm(shape):
    """vsplit=2 over [2B, C, ...] against two sequential calls (outputs,
    input and affine gradients, running statistics ticked twice) and
    against the JAX BatchNorm(vsplit=2) (outputs and statistics); eval mode
    ignores vsplit."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    c = shape[1]
    make = (lambda: BatchNorm2d(c)) if len(shape) == 4 else (lambda: BatchNorm1d(c))
    fused, seq = make(), make()
    with torch.no_grad():
        for bn in (fused, seq):
            bn.weight.copy_(torch.linspace(0.5, 1.5, c))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
    outs = []
    for bn, fn in ((fused, lambda bn, t: bn(t, vsplit=2)),
                   (seq, lambda bn, t: torch.cat([bn(t[:3]), bn(t[3:])]))):
        t = torch.from_numpy(x).requires_grad_()
        y = fn(bn, t)
        grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                    [t, bn.weight, bn.bias])
        outs.append((y.detach(), *grads))
    for got, ref in zip(*outs):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(fused, name).numpy(),
                                   getattr(seq, name).numpy(), rtol=0, atol=1e-6)
    assert int(fused.num_batches_tracked) == int(seq.num_batches_tracked) == 2

    # the JAX class from the same start (NHWC, its momentum is the decay)
    perm = (0, 2, 3, 1) if len(shape) == 4 else (0, 1)
    params = {"scale": np.linspace(0.5, 1.5, c, dtype=np.float32),
              "bias": np.linspace(-0.2, 0.2, c, dtype=np.float32)}
    stats = {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
    y, upd = JaxBatchNorm(use_running_average=False, momentum=0.1, epsilon=1e-5,
                          vsplit=2).apply({"params": params, "batch_stats": stats},
                                          jnp.asarray(x.transpose(perm)),
                                          mutable=["batch_stats"])
    np.testing.assert_allclose(outs[0][0].numpy().transpose(perm), np.asarray(y),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(fused.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(fused.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    fused.eval()
    t = torch.from_numpy(x)
    assert torch.equal(fused(t, vsplit=2), fused(t))


def test_vsplit_with_pallas_bn_raises():
    bn = BatchNorm2d(3, pallas=True)
    x = torch.ones((4, 3, 2, 2))
    with pytest.raises(ValueError, match="vsplit>1 \\+ pallas"):
        bn(x, vsplit=2)
    bn.eval()
    assert bn(x, vsplit=2).shape == x.shape  # eval mode ignores vsplit
    cfg = _with(_configs("tiny", True), fused_decoder_batch=True)[1]
    groups = convert.random_groups(cfg, 0, "vae-gan")
    eps = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="vsplit>1 \\+ pallas"):
        make_vgan_stage1_step(cfg).train_step(
            _port_state(groups, cfg), torch.from_numpy(_images(cfg, 4, 0)), eps, eps,
            MARGIN, 0.68, LAMBDA_MSE)


@pytest.mark.parametrize("build", [
    lambda c: nets.VisualEncoder(c.model), lambda c: nets.CognitiveEncoder(c.model),
    lambda c: nets.Decoder(c.model), lambda c: nets.ImageDiscriminator(c.model),
    lambda c: VaeGan(c), lambda c: VaeGanCognitiveTrain(c),
    lambda c: VaeGanCognitive(c.model), lambda c: make_vgan_stage1_step(c),
    lambda c: make_vgan_cognitive_step(c, 2)],
    ids=["visual", "cognitive", "decoder", "discriminator", "vaegan",
         "cognitive-train", "eval", "stage1-step", "cognitive-step"])
def test_alt_backward_builds_and_routes(monkeypatch, build):
    """Every net and step factory builds with ``alt_backward`` (nothing
    refuses it any more). A net's train-mode pullback to its weights takes
    the rewrites where the JAX package's would (``fmri_tpu/models/nets.py:83,
    215,241``): dx by phases in the stride-2 ``EncoderBlock`` convs, dW by
    patches in the decoder's out conv and the discriminator's 8-channel
    layer 0 at tiny; the cognitive encoder has no conv. A pullback that
    needs no dx (the encoder's first conv, on the image) runs none."""
    calls = {"phases": 0, "patches": 0}
    for key, name in (("phases", "conv2d_dx_phases"), ("patches", "conv2d_dw_patches")):
        def call(*args, _orig=getattr(conv_alt, name), _key=key):
            calls[_key] += 1
            return _orig(*args)

        monkeypatch.setattr(conv_alt, name, call)
    cfg = _with(_configs("tiny"), alt_backward=True)[1]
    built = build(cfg)
    if not isinstance(built, torch.nn.Module):
        assert callable(built.train_step)
        return
    parts = ([built] if not hasattr(built, "decoder")
             else [built.encoder, built.decoder])
    want = {"phases": 0, "patches": 0}
    for net in parts:
        net.train()
        if isinstance(net, nets.CognitiveEncoder):
            out = net(torch.ones((4, cfg.model.num_voxels)))[0]
        elif isinstance(net, nets.Decoder):
            out = net(torch.ones((4, cfg.model.latent_dim)))
            want["patches"] += 1
        else:
            out = net(torch.ones((4, 16, 16, 3)))[1]  # logvar, or the score
            disc = isinstance(net, nets.ImageDiscriminator)
            # the encoder's first conv reads the image: no dx to pull back
            want["phases"] += 3 if disc else 2
            want["patches"] += disc
        torch.autograd.grad(out.sum(), list(net.parameters()), allow_unused=True)
    assert calls == want


def test_inference_cli_stage1(tmp_path, capsys):
    """``--family vgan --stage 1`` on tiny synthetic images: image -> image
    through the stage-I model with running statistics, scored against the
    input images, as the JAX eval step over the same held-out images."""
    jcfg, cfg = _configs("tiny")
    groups = convert.random_groups(cfg, 3, "vae-gan")
    pth = str(tmp_path / "stage1.pth")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in export_state_dict(groups, jcfg, kind="vae-gan").items()}, pth)
    out = str(tmp_path / "out")
    assert inference.main(["--family", "vgan", "--stage", "1", "--preset", "tiny",
                           "--ckpt", pth, "--synthetic-n", "40", "--batch-size", "8",
                           "-o", out, "--device", "cpu"]) == 0
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert json.loads(capsys.readouterr().out) == summary
    assert summary["num_images"] == 8  # max(40 // 10, 8) held out
    images = synthetic_images(40, 16, seed=0)[0][:8]
    step = jax_step(jcfg, donate=False).eval_step
    ref_r, ref_t = jax_eval.reconstruct_dataset(step, jax_state(groups), [{"image": images}],
                                                data_kind="image")
    ref = jax_eval.quality_metrics(ref_r, ref_t, with_is=False)
    for k in ref:
        assert summary[k] == pytest.approx(ref[k], abs=1e-5), k
    scores = jax_eval.objective_scores(ref_r, ref_t)
    for k in ("pcc", "ssim"):
        np.testing.assert_allclose(summary["objective"][k], scores[k], atol=1.0 / 8 + 1e-12)
    model = VaeGanVisual(cfg.model)
    model.load_state_dict(convert.load_pth(pth), strict=True)
    with torch.no_grad():
        x = torch.from_numpy(2.0 * images - 1.0)
        np.testing.assert_allclose(model.reconstruct(x).numpy() * 0.5 + 0.5, ref_r,
                                   atol=1e-5)
    # the WAE/Dual-GAN family reads the same triplet's encoder and decoder
    # (its --stage is ignored); without --sample, the same reconstructions
    out2 = str(tmp_path / "wae_vgan")
    assert inference.main(["--family", "wae-vgan", "--preset", "tiny", "--ckpt", pth,
                           "--synthetic-n", "40", "--batch-size", "8", "-o", out2,
                           "--device", "cpu"]) == 0
    capsys.readouterr()
    with open(os.path.join(out2, "summary.json")) as f:
        assert {k: v for k, v in json.load(f).items() if k != "checkpoint"} == {
            k: v for k, v in summary.items() if k != "checkpoint"}
    assert sorted(GROUPS) == sorted({k.split(".")[0] for k in convert.load_train_pth(pth)})
    _port_nets(groups, cfg)  # the train module takes the same weights strictly
