"""The port's stage-I VAE/GAN train step (``fmri_tpu_torch/train``) against
the JAX package's ``make_vgan_stage1_step``, on the CPU.

Both sides start from the same seeded numpy groups (``random_groups(...,
"vae-gan")``; the port loads them through ``from_jax_groups``), the same
images, and the JAX step's own eps/z_p draws (split from its key as
``steps_vgan.py:236-238`` does), injected into the port. RMSprop moments
start at ones on both sides (``moments_from_jax``), as
``tests/ref_oracle.py:110`` warms them: from zero moments any gradient gives
about +-3.16 lr sign(g), and the update flips on rounding noise.

Tolerances, stated per case in ``CASES``, after step 1 and after step 3:
the losses relative; for every tensor the L2 norm of the port's difference
from the JAX step, relative to how far the JAX step moved the parameter
from its start (``param``), or to the JAX value for BN running statistics
(``stats``) and RMSprop moments (``sq``). Each bound is about twice the
gap that ``tests/torch_step_drift.py`` measures (CPU):
  * tiny, fp32, kernel flags off or on: fp32 rounding (losses 3e-7,
    parameter movement 4e-4, stats 1e-6, moments 2e-6);
  * res64, fp32, flags off, batch 4: losses 4e-7 after one step, but the
    update is ill-conditioned (BatchNorm over 4 images, KL terms near 950
    per image): against a float64 run of the port, the fp32 update of
    either package is off by up to 7% of the tensor's largest update on
    single elements. Parameter movement 0.9% after one step and 10% after
    three, moments 0.5% and 9%, stats 2e-6 and 0.7%, losses 1e-4 after
    three;
  * tiny, bf16 conv/matmul operands: the two frameworks round to bf16 at
    other places (losses 1.2e-3, parameter movement 32%, moments 14%,
    stats 0.6%).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmri_tpu.checkpoints.torch_import import export_state_dict
from fmri_tpu.configs import presets as jax_presets
from fmri_tpu.losses import gan_losses as jax_losses
from fmri_tpu.models.nets import Decoder as JaxDecoder
from fmri_tpu.models.nets import ImageDiscriminator as JaxDisc
from fmri_tpu.models.nets import VisualEncoder as JaxEncoder
from fmri_tpu.train import RmsProp as JaxRmsProp
from fmri_tpu.train import exponential_lr as jax_exponential_lr
from fmri_tpu.train import init_vaegan as jax_init_vaegan
from fmri_tpu.train import make_state as jax_make_state
from fmri_tpu.train import make_vgan_stage1_step as jax_step
from fmri_tpu.train.common import apply_with_stats
from fmri_tpu.train.optim import RmsState
from fmri_tpu_torch.checkpoints.convert import (
    from_jax_groups, moments_from_jax, random_groups,
)
from fmri_tpu_torch.configs import presets
from fmri_tpu_torch.losses import gan_losses
from fmri_tpu_torch.train.optim import RmsProp, exponential_lr
from fmri_tpu_torch.train.state import (
    GROUPS, VaeGan, init_vaegan, make_state,
)
from fmri_tpu_torch.train.steps_vgan import MODES, make_vgan_stage1_step

MARGIN, EQUILIBRIUM, LAMBDA_MSE = 0.35, 0.68, 1e-6


def _configs(preset, flags=False, dtype=None):
    """(JAX config, port config) of ``preset`` with both kernel flags set to
    ``flags`` and an optional compute dtype."""
    kw = dict(pallas_bn=flags, pallas_backward=flags)
    if dtype:
        kw["compute_dtype"] = dtype
    out = []
    for mod in (jax_presets, presets):
        cfg = mod.get_config(preset)
        out.append(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw)))
    return tuple(out)


def _port_nets(groups, cfg):
    nets = VaeGan(cfg)
    nets.load_state_dict(from_jax_groups(groups, cfg, "vae-gan"), strict=True)
    return nets


def _images(cfg, b, seed):
    s = cfg.model.image_size
    return np.random.default_rng(seed).uniform(-1, 1, (b, s, s, 3)).astype(np.float32)


def _noise(key, b, latent):
    k_eps, k_zp = jax.random.split(key)
    return tuple(np.array(jax.random.normal(k, (b, latent), jnp.float32))
                 for k in (k_eps, k_zp))


# ---------------------------------------------------------------- weights


def test_random_groups_have_the_flax_tree():
    c = jax_presets.get_config("tiny").model
    ref = jax.eval_shape(lambda: jax_init_vaegan(jax.random.key(0),
                                                 jax_presets.get_config("tiny")))
    got = random_groups(presets.get_config("tiny"), 0, "vae-gan")
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)  # noqa: E731
    for g in GROUPS:
        assert shapes(got[g]["params"]) == shapes(ref["params"][g]), g
        assert shapes(got[g]["batch_stats"]) == shapes(ref["batch_stats"][g]), g
    assert c.image_size == 16


@pytest.mark.parametrize("preset", ["tiny", "res64"])
def test_state_dict_loads_strict_and_equals_export(preset):
    jcfg, cfg = _configs(preset)
    groups = random_groups(cfg, 1, "vae-gan")
    ref = export_state_dict(groups, jcfg, kind="vae-gan")
    got = from_jax_groups(groups, cfg, "vae-gan")
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    VaeGan(cfg).load_state_dict({k: torch.from_numpy(np.asarray(v))
                                 for k, v in ref.items()}, strict=True)


def test_moments_take_the_weight_permutation():
    """Moment trees go through the same permutations as the parameters."""
    cfg = presets.get_config("tiny")
    groups = random_groups(cfg, 2, "vae-gan")
    weights = from_jax_groups(groups, cfg, "vae-gan")
    moments = moments_from_jax({g: groups[g]["params"] for g in GROUPS}, cfg)
    nets = VaeGan(cfg)
    for g in GROUPS:
        assert sorted(moments[g]) == sorted(nets.group(g))
        for k, v in moments[g].items():
            assert torch.equal(v, weights[f"{g}.{k}"]), (g, k)


def test_init_vaegan_follows_the_reference_init():
    nets = init_vaegan(presets.get_config("tiny"), seed=0)
    w = nets.decoder.conv[0].conv.weight.detach()  # IOHW: fan_in = Ci * k * k
    bound = (3.0 * w.shape[0] * 25) ** -0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert float(nets.discriminator.conv[0][0].bias.detach().abs().max()) == 0.0
    assert torch.equal(init_vaegan(presets.get_config("tiny"), seed=0).state_dict()
                       ["encoder.fc.0.weight"],
                       nets.state_dict()["encoder.fc.0.weight"])


# ---------------------------------------------------------------- forwards


def _jax_forward(module, group, x, train):
    if train:
        return apply_with_stats(module, group["params"], group["batch_stats"], x,
                                train=True)
    return module.apply(group, x, train=False), None


@pytest.mark.parametrize("preset,flags", [("tiny", False), ("tiny", True),
                                          ("res64", False)])
@pytest.mark.parametrize("train", [True, False])
def test_forwards_and_batch_stats_match_jax(preset, flags, train):
    """Each net in train mode (outputs and the new BN running stats) and in
    eval mode. fp32: rtol 1e-4, atol 1e-5 on outputs; rtol 1e-4, atol 1e-6
    on the stats (torch normalises with a two-pass or Welford variance,
    flax's stock path with E[x^2] - E[x]^2)."""
    jcfg, cfg = _configs(preset, flags)
    groups = random_groups(cfg, 3, "vae-gan")
    nets = _port_nets(groups, cfg).train(train)
    b = 3
    x = _images(cfg, b, 4)
    z = np.random.default_rng(5).normal(size=(b, cfg.model.latent_dim)).astype(np.float32)
    c = jcfg.model
    new = {}
    with torch.no_grad():
        for name, jmod, inp in (("encoder", JaxEncoder(c), x),
                                ("decoder", JaxDecoder(c), z),
                                ("discriminator", JaxDisc(c), np.concatenate([x] * 3))):
            ref, new[name] = _jax_forward(jmod, groups[name], jnp.asarray(inp), train)
            got = getattr(nets, name)(torch.from_numpy(inp))
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for r, g in zip(ref, got):
                r = np.asarray(r)
                if name == "discriminator" and r.ndim == 2 and r.shape[1] > 1:
                    # the JAX tap is flattened HWC-major, the port's C-major
                    hw = c.fc_input_gan * 2 if c.recon_level == 2 else c.fc_input_gan
                    r = r.reshape(-1, hw, hw, r.shape[1] // hw // hw).transpose(0, 3, 1, 2)
                    r = r.reshape(r.shape[0], -1)
                np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5,
                                           err_msg=name)
    if train:
        ref = from_jax_groups({g: {"params": groups[g]["params"],
                                   "batch_stats": new[g]} for g in GROUPS},
                              cfg, "vae-gan")
        got = nets.state_dict()
        stats = [k for k in ref if "running" in k]
        assert stats
        for k in stats:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- losses


def _terms_inputs(seed, b=5, f=7):
    rng = np.random.default_rng(seed)
    x, xt = rng.uniform(-1, 1, (2, b, 4, 4, 3)).astype(np.float32)
    fo, fp = rng.normal(size=(2, b, f)).astype(np.float32)
    so, sp, ss = rng.uniform(0.05, 0.95, (3, b, 1)).astype(np.float32)
    mu, lv = rng.normal(size=(2, b, 6)).astype(np.float32)
    return x, xt, fo, fp, so, sp, ss, mu, lv


@pytest.mark.parametrize("mode", ["vae-gan", "beta-vae", "dcgan", "vae"])
def test_losses_match_jax(mode):
    args = _terms_inputs(0)
    ref_t = jax_losses.vaegan_terms(*map(jnp.asarray, args))
    got_t = gan_losses.vaegan_terms(*map(torch.from_numpy, args))
    for r, g in zip(ref_t, got_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    ref = jax_losses.combine_mode(ref_t, mode, lambda_mse=0.3, beta=2.0, batch_size=5)
    got = gan_losses.combine_mode(got_t, mode, lambda_mse=0.3, beta=2.0, batch_size=5)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6)


@pytest.mark.parametrize("eq,margin,init_dis", [
    (0.68, 0.35, True), (0.2, 0.1, True), (3.0, 0.1, True), (0.68, 0.35, False),
    (1.0, 0.0, True)])
def test_equilibrium_gate_matches_jax(eq, margin, init_dis):
    for seed in range(4):
        args = _terms_inputs(seed)
        ref = jax_losses.equilibrium_gate(
            jax_losses.vaegan_terms(*map(jnp.asarray, args)), eq, margin,
            init_dis=init_dis)
        got = gan_losses.equilibrium_gate(
            gan_losses.vaegan_terms(*map(torch.from_numpy, args)),
            torch.tensor(eq), torch.tensor(margin), init_dis=init_dis)
        assert [bool(g) for g in got] == [bool(r) for r in ref]


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("gate", [0.0, 1.0])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_rmsprop_matches_jax_and_gate_freezes(gate, clip):
    rng = np.random.default_rng(7)
    p0, s0 = rng.normal(size=(2, 4, 3)).astype(np.float32)
    s0 = np.abs(s0)
    grads = rng.normal(size=(3, 4, 3)).astype(np.float32)
    jopt = JaxRmsProp(decay=0.9, eps=1e-8, clip=clip)
    jp, js = jnp.asarray(p0), RmsState(jnp.asarray(s0))
    opt = RmsProp(decay=0.9, eps=1e-8, clip=clip)
    params, sq = {"w": torch.tensor(p0)}, {"w": torch.tensor(s0)}
    for g in grads:
        jp, js = jopt.update(jnp.asarray(g), js, jp, jnp.float32(1e-2), gate)
        opt.update({"w": torch.from_numpy(g)}, sq, params, torch.tensor(1e-2),
                   torch.tensor(gate))
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sq["w"].numpy(), np.asarray(js.sq_avg), rtol=1e-6)
    if gate == 0.0:
        assert np.array_equal(params["w"].numpy(), p0)
        assert np.array_equal(sq["w"].numpy(), s0)


def test_exponential_lr_matches_jax():
    ref = jax_exponential_lr(1e-4, 0.98, 7)
    got = exponential_lr(1e-4, 0.98, 7)
    for step in (0, 6, 7, 50, 1400):
        np.testing.assert_allclose(float(got(torch.tensor(step))),
                                   float(ref(jnp.asarray(step))), rtol=1e-6)


# ---------------------------------------------------------------- the step


def _port_state(groups, cfg, nets=None):
    t = cfg.train
    ones = {g: jax.tree_util.tree_map(np.ones_like, groups[g]["params"])
            for g in GROUPS}
    return make_state(nets if nets is not None else _port_nets(groups, cfg),
                      {g: RmsProp(t.rms_decay, t.rms_eps) for g in GROUPS},
                      moments_from_jax(ones, cfg))


def _jax_state(groups, jcfg):
    t = jcfg.train
    state = jax_make_state(groups, {g: JaxRmsProp(t.rms_decay, t.rms_eps)
                                    for g in GROUPS})
    return state.replace(opt_state={
        g: RmsState(jax.tree_util.tree_map(jnp.ones_like, s.sq_avg))
        for g, s in state.opt_state.items()})


@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_spliced_equals_naive(mode, flags):
    """Both backwards give the same update in every mode: the spliced one is
    a rearrangement by linearity (fp32 reassociation only: atol 1e-7 on
    parameters, whose updates are about 3e-4); 'dcgan' leaves the encoder
    alone in both."""
    _, cfg = _configs("tiny", flags)
    groups = random_groups(cfg, 4, "vae-gan")
    nets = _port_nets(groups, cfg)
    x = torch.from_numpy(_images(cfg, 6, 8))
    eps, z_p = (torch.from_numpy(a) for a in _noise(jax.random.key(9), 6,
                                                     cfg.model.latent_dim))
    out = {}
    for backward in ("spliced", "naive"):
        state = _port_state(groups, cfg, copy.deepcopy(nets))
        step = make_vgan_stage1_step(cfg, mode, backward=backward)
        state, m = step.train_step(state, x, eps, z_p, MARGIN, EQUILIBRIUM, 0.3)
        out[backward] = (state, m)
    (s1, m1), (s2, m2) = out["spliced"], out["naive"]
    for k in m1:
        assert float(m1[k]) == pytest.approx(float(m2[k]), rel=1e-6), k
    sd1, sd2 = s1.nets.state_dict(), s2.nets.state_dict()
    start = nets.state_dict()
    for k in sd1:
        np.testing.assert_allclose(sd1[k].numpy(), sd2[k].numpy(), rtol=0, atol=1e-7,
                                   err_msg=k)
        if mode == "dcgan" and k.startswith("encoder.") and "running" not in k \
                and "num_batches" not in k:
            assert torch.equal(sd1[k], start[k]) and torch.equal(sd2[k], start[k]), k
    assert int(s1.step) == 1


# (preset, kernel flags, compute dtype, batch, bounds after step 1, after step 3)
CASES = {
    "tiny-fp32": ("tiny", False, None, 8,
                  dict(loss=1e-6, param=1e-3, stats=1e-5, sq=1e-5),
                  dict(loss=1e-6, param=1e-3, stats=1e-5, sq=1e-5)),
    "tiny-fp32-kernels": ("tiny", True, None, 8,
                          dict(loss=1e-6, param=1e-3, stats=1e-5, sq=1e-5),
                          dict(loss=1e-6, param=1e-3, stats=1e-5, sq=1e-5)),
    "res64-fp32": ("res64", False, None, 4,
                   dict(loss=1e-6, param=2e-2, stats=1e-5, sq=1e-2),
                   dict(loss=2e-4, param=0.2, stats=1.5e-2, sq=0.2)),
    "tiny-bf16": ("tiny", False, "bfloat16", 8,
                  dict(loss=5e-3, param=0.6, stats=1.5e-2, sq=0.3),
                  dict(loss=5e-3, param=0.6, stats=1.5e-2, sq=0.3)),
}


def _rel(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> float:
    return float((got.double() - ref.double()).norm()
                 / max(float(scale.double().norm()), 1e-30))


def _compare(jstate, jm, state, m, cfg, start, tol):
    for k, r in jm.items():
        assert float(m[k]) == pytest.approx(float(r), rel=tol["loss"], abs=1e-7), k
    ref = from_jax_groups({g: {"params": jstate.params[g],
                               "batch_stats": jstate.batch_stats[g]}
                           for g in GROUPS}, cfg, "vae-gan")
    got = state.nets.state_dict()
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            assert _rel(got[k], r, r) <= tol["stats"], k
        elif not torch.equal(r, start[k]):
            assert _rel(got[k], r, r - start[k]) <= tol["param"], k
        else:  # a gated-off group: the port must not move it either
            assert torch.equal(got[k], start[k]), k
    ref_sq = moments_from_jax({g: jstate.opt_state[g].sq_avg for g in GROUPS}, cfg)
    for g in GROUPS:
        for k, r in ref_sq[g].items():
            assert _rel(state.opt_state[g][k], r, r) <= tol["sq"], f"{g}.{k}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(case):
    """Metrics, gate flags, parameters, BN running stats and RMSprop moments
    after one step and after three, from the same state and noise."""
    step_matches_jax(CASES[case])


def step_matches_jax(spec):
    """``test_step_matches_jax`` for one ``CASES``-style tuple (also the
    res100 case of ``tests/test_torch_res100.py``)."""
    preset, flags, dtype, b, tol1, tol3 = spec
    jcfg, cfg = _configs(preset, flags, dtype)
    groups = random_groups(cfg, 0, "vae-gan")
    jstate, state = _jax_state(groups, jcfg), _port_state(groups, cfg)
    jfns = jax_step(jcfg, "vae-gan", donate=False)
    fns = make_vgan_stage1_step(cfg)
    # the eval path first: running statistics, z = mu
    x = _images(cfg, 2, 20)
    np.testing.assert_allclose(fns.eval_step(state, torch.from_numpy(x)).numpy(),
                               np.asarray(jfns.eval_step(jstate, jnp.asarray(x))),
                               rtol=0, atol=2e-2 if dtype else 1e-4)
    start = {k: v.clone() for k, v in state.nets.state_dict().items()}
    gates = []
    for i in range(3):
        x = _images(cfg, b, 10 + i)
        key = jax.random.key(100 + i)
        eps, z_p = _noise(key, b, cfg.model.latent_dim)
        jstate, jm = jfns.train_step(jstate, jnp.asarray(x), key, jnp.float32(MARGIN),
                                     jnp.float32(EQUILIBRIUM), jnp.float32(LAMBDA_MSE))
        state, m = fns.train_step(state, torch.from_numpy(x), torch.from_numpy(eps),
                                  torch.from_numpy(z_p), MARGIN, EQUILIBRIUM,
                                  LAMBDA_MSE)
        gates.append((float(m["train_dec"]), float(m["train_dis"])))
        assert gates[-1] == (float(jm["train_dec"]), float(jm["train_dis"]))
        if i in (0, 2):
            _compare(jstate, jm, state, m, cfg, start, tol1 if i == 0 else tol3)
    assert int(state.step) == int(jstate.step) == 3
