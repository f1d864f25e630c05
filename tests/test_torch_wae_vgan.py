"""The port's WAE/Dual-GAN step (``fmri_tpu_torch/train/steps_wae.py::
make_wae_vgan_step``) against the JAX package's ``make_wae_vgan_step`` on
the CPU at ``tiny``: the four modes, the spliced and naive backwards, and
the fused decoder batch.

Both packages start from the same seeded ``"wae-vgan"`` groups (the
stage-I triplet and the latent discriminator), the same images and the JAX
step's own eps / z_p / z_fake draws (split from its key as
``steps_wae.py:445-449`` does). RMSprop's ``sq_avg`` starts at ones on both
sides, as ``tests/test_torch_train.py`` warms it. Tolerances are
``tests/test_torch_wae.py``'s ``TOL`` (losses 1e-6 relative, parameter
movement 1e-3, BN statistics 1e-5, moments 1e-5), after step 1 and after
step 3. The spliced port folds the penalty's cotangent into its one
encoder backward where the JAX step runs a second one: the same sum, to
fp32 rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wae import (
    EQUILIBRIUM, LAMBDA_MSE, MARGIN, compare, configs, count_kernel_calls, images,
    jax_state, port_moments, ticks,
)

from fmri_tpu.train import RmsProp as JaxRmsProp
from fmri_tpu.train import make_wae_vgan_step as jax_step
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.train.state import WAE_DUAL_GROUPS, WaeDualGan, make_wae_dual_gan_state
from fmri_tpu_torch.train.steps_vgan import MODES
from fmri_tpu_torch.train.steps_wae import make_wae_vgan_step

KIND = "wae-vgan"


def _states(groups, jcfg, cfg):
    t = jcfg.train
    jstate = jax_state(groups, WAE_DUAL_GROUPS,
                       lambda g: JaxRmsProp(t.rms_decay, t.rms_eps, clip=t.grad_clip))
    nets = WaeDualGan(cfg)
    nets.load_state_dict(convert.from_jax_groups(groups, cfg, KIND), strict=True)
    return jstate, make_wae_dual_gan_state(
        nets, cfg, port_moments(groups, WAE_DUAL_GROUPS, cfg, KIND, adam=False))


def _noise(key, b, latent, sigma=0.5):
    """eps, z_p, z_fake as the JAX step draws them from its key."""
    k_eps, k_zp, k_zf = jax.random.split(key, 3)
    return (np.array(jax.random.normal(k_eps, (b, latent), jnp.float32)),
            np.array(jax.random.normal(k_zp, (b, latent), jnp.float32)),
            np.array(sigma * jax.random.normal(k_zf, (b, latent), jnp.float32)))


def _run(jcfg, cfg, mode, backward, groups, steps=3, check=(0, 2)):
    """Both packages' step from one state; compares after the steps in
    ``check``. Returns the port's state."""
    jstate, state = _states(groups, jcfg, cfg)
    jfns = jax_step(jcfg, mode, donate=False, backward=backward)
    fns = make_wae_vgan_step(cfg, mode, backward=backward)
    start = {k: v.clone() for k, v in state.nets.state_dict().items()}
    for i in range(steps):
        x = images(cfg, 8, 10 + i)
        key = jax.random.key(100 + i)
        jstate, jm = jfns.train_step(jstate, jnp.asarray(x), key, jnp.float32(MARGIN),
                                     jnp.float32(EQUILIBRIUM), jnp.float32(LAMBDA_MSE))
        state, m = fns.train_step(state, torch.from_numpy(x),
                                  *map(torch.from_numpy, _noise(key, 8, 16)),
                                  MARGIN, EQUILIBRIUM, LAMBDA_MSE)
        assert (float(m["train_dec"]), float(m["train_dis"])) == (
            float(jm["train_dec"]), float(jm["train_dis"]))
        if i in check:
            compare(jstate, jm, state, m, cfg, KIND, start,
                    ("encoder.",) if mode == "dcgan" else ())
    return state


@pytest.mark.parametrize("backward", ["spliced", "naive"])
@pytest.mark.parametrize("mode", MODES)
def test_step_matches_jax(mode, backward):
    """Every mode and backward against the JAX step, the port with both
    kernel flags on (their plain versions on the CPU), the JAX step with
    them off: metrics, gates, parameters, BN statistics and RMSprop moments
    (the decoder's decayed once more by the zero-grad step) after steps 1
    and 3. Per step the encoder's BatchNorms tick three times (one forward,
    two replayed), the decoder's three times (x_tilde, x_p and the
    stats-only decode of mu), the image discriminator's once. 'dcgan'
    leaves the encoder's parameters alone."""
    jcfg, _ = configs()
    _, cfg = configs(True, True)
    state = _run(jcfg, cfg, mode, backward, convert.random_groups(cfg, 0, KIND))
    assert ticks(state, "encoder.") == {9} and ticks(state, "decoder.") == {9}
    assert ticks(state, "discriminator.") == {3}


def test_step_matches_jax_with_the_jax_kernels():
    """One case with the JAX package's Pallas kernels on too (interpret
    mode on the CPU): 'vae-gan', spliced, one step."""
    jcfg, cfg = configs(True, True)
    _run(jcfg, cfg, "vae-gan", "spliced", convert.random_groups(cfg, 1, KIND), steps=1,
         check=(0,))


@pytest.mark.parametrize("mode", MODES)
def test_spliced_equals_naive(mode):
    """Both backwards give the same update (atol 1e-7 on parameters, whose
    updates are about 1e-4) and the same metrics (1e-6)."""
    _, cfg = configs()
    groups = convert.random_groups(cfg, 4, KIND)
    x = torch.from_numpy(images(cfg, 6, 8))
    noise = [torch.from_numpy(a) for a in _noise(jax.random.key(9), 6, 16)]
    out = {}
    for backward in ("spliced", "naive"):
        state = _states(groups, configs()[0], cfg)[1]
        out[backward] = make_wae_vgan_step(cfg, mode, backward=backward).train_step(
            state, x, *noise, MARGIN, EQUILIBRIUM, 0.3)
    (s1, m1), (s2, m2) = out["spliced"], out["naive"]
    for k in m1:
        assert float(m1[k]) == pytest.approx(float(m2[k]), rel=1e-6), k
    sd2 = s2.nets.state_dict()
    for k, v in s1.nets.state_dict().items():
        np.testing.assert_allclose(v.numpy(), sd2[k].numpy(), rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("pallas_backward", [False, True])
def test_fused_decoder_batch(pallas_backward):
    """``fused_decoder_batch`` (one vsplit=2 decode of [z, z_p]; the
    stats-only decode of mu stays a pass of its own) gives the unfused
    step's update (atol 1e-6: E[x^2] - mean^2 against torch's two-pass
    variance) and the JAX fused step's, ``pallas_bn`` off (vsplit forbids
    it; the JAX step's kernel flags off)."""
    jcfg = configs(fused=True)[0]
    cfg = configs(pallas_backward=pallas_backward, fused=True)[1]
    groups = convert.random_groups(cfg, 0, KIND)
    fused = _run(jcfg, cfg, "vae-gan", "spliced", groups, steps=2, check=(1,))
    _, cfg_seq = configs(pallas_backward=pallas_backward)
    seq = _states(groups, configs()[0], cfg_seq)[1]
    step = make_wae_vgan_step(cfg_seq)
    for i in range(2):
        key = jax.random.key(100 + i)
        seq, _ = step.train_step(seq, torch.from_numpy(images(cfg, 8, 10 + i)),
                                 *map(torch.from_numpy, _noise(key, 8, 16)),
                                 MARGIN, EQUILIBRIUM, LAMBDA_MSE)
    ref = seq.nets.state_dict()
    for k, v in fused.nets.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("backward,want", [("spliced", (17, 17, 15)),
                                           ("naive", (23, 23, 18))])
def test_kernel_calls_per_step(monkeypatch, backward, want):
    """Calls of the BN-backward and weight-grad wrappers per 'vae-gan' step
    with both kernel flags on (on the card, one launch each). Spliced: the
    stage-I step's 17 / 17 / 15, since the penalty joins the one encoder
    backward. Naive: the stage-I naive step's, plus the penalty's own
    encoder backward (3 BN, 3 weight grads). Fused with ``pallas_bn`` off:
    the weight grads of one decoder pass, 3 + 4 + 4 = 11."""
    counts = count_kernel_calls(monkeypatch)
    cases = [(configs(True, True)[1], want)]
    if backward == "spliced":
        cases.append((configs(False, True, fused=True)[1], (0, 0, 11)))
    for cfg, expect in cases:
        state = _states(convert.random_groups(cfg, 0, KIND), configs()[0], cfg)[1]
        noise = [torch.from_numpy(a) for a in _noise(jax.random.key(0), 4, 16)]
        counts.reset()
        make_wae_vgan_step(cfg, backward=backward).train_step(
            state, torch.from_numpy(images(cfg, 4, 0)), *noise, MARGIN, EQUILIBRIUM,
            LAMBDA_MSE)
        assert counts.read() == expect


def test_latent_d_weight_is_wae_vgan_lam():
    """The latent D's loss weight is ``wae_vgan_lam`` (1.0), not
    ``wae_lambda`` (10): the latent D's reported losses scale with it (the
    penalty is taken after the D's update, which the weight moves too)."""
    _, cfg = configs()
    groups = convert.random_groups(cfg, 2, KIND)
    x = torch.from_numpy(images(cfg, 4, 2))
    noise = [torch.from_numpy(a) for a in _noise(jax.random.key(2), 4, 16)]
    out = []
    for lam in (1.0, 3.0):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, wae_vgan_lam=lam))
        state = _states(groups, configs()[0], c)[1]
        out.append(make_wae_vgan_step(c).train_step(state, x, *noise, MARGIN, EQUILIBRIUM,
                                                    LAMBDA_MSE)[1])
    for k in ("loss_discriminator_fake", "loss_discriminator_real"):
        assert float(out[1][k]) == pytest.approx(3.0 * float(out[0][k]), rel=1e-6), k
