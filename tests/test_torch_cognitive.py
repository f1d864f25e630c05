"""The port's stage-II and stage-III cognitive VAE/GAN train steps
(``fmri_tpu_torch/train/steps_vgan.py::make_vgan_cognitive_step``) against
the JAX package's ``make_vgan_cognitive_step``, on the CPU at ``tiny``; the
cognitive train module and its weights.

Both sides start from the same seeded numpy groups (``random_groups(...,
"vae-gan-cognitive")``: cognitive encoder, decoder, discriminator and the
stage-I teacher encoder; the port loads them through ``from_jax_groups``),
the same fMRI and images, and the JAX step's own eps / eps_t / z_p draws
(split from its key as ``steps_vgan.py:545-548`` does), injected into the
port. RMSprop moments of the trained groups start at ones on both sides.

Tolerances, after step 1 and after step 3 (``TOL``): the losses within
1e-6 relative; for every tensor the L2 norm of the port's difference from
the JAX step, relative to how far the JAX step moved the parameter (1e-3),
or to the JAX value for BN running statistics (1e-5) and RMSprop moments
(1e-5). That is fp32 rounding at ``tiny``, as for the stage-I step
(``tests/test_torch_train.py``); parameters the step must not move are held
bitwise.
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
from fmri_tpu.train import RmsProp as JaxRmsProp
from fmri_tpu.train import make_state as jax_make_state
from fmri_tpu.train import make_vgan_cognitive_step as jax_step
from fmri_tpu.train.optim import RmsState
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.configs import presets
from fmri_tpu_torch.eval.steps import VaeGanCognitive
from fmri_tpu_torch.ops import bn as port_bn
from fmri_tpu_torch.ops import dw as port_dw
from fmri_tpu_torch.train.state import (
    COGNITIVE_TRAINED, VaeGan, VaeGanCognitiveTrain, init_cognitive, init_vaegan,
    make_cognitive_state,
)
from fmri_tpu_torch.train.steps_vgan import MODES, make_vgan_cognitive_step

MARGIN, EQUILIBRIUM, LAMBDA_MSE = 0.35, 0.68, 1e-6
KIND = "vae-gan-cognitive"
GROUPS4 = ("encoder", "decoder", "discriminator", "teacher_encoder")
TOL = dict(loss=1e-6, param=1e-3, stats=1e-5, sq=1e-5)
# the state-dict prefixes of the groups each stage freezes
# (teacher_net.decoder/.discriminator are the student's own modules)
FROZEN = {2: ("decoder.", "teacher_net.encoder.", "teacher_net.decoder."),
          3: ("encoder.", "teacher_net.encoder.")}


def _configs(pallas_bn=False, pallas_backward=False, fused=False):
    """(JAX config, port config) at tiny with the given flags."""
    kw = dict(pallas_bn=pallas_bn, pallas_backward=pallas_backward,
              fused_decoder_batch=fused)
    return tuple(dataclasses.replace(m.get_config("tiny"), model=dataclasses.replace(
        m.get_config("tiny").model, **kw)) for m in (jax_presets, presets))


def _port_nets(groups, cfg):
    nets = VaeGanCognitiveTrain(cfg)
    nets.load_state_dict(convert.from_jax_groups(groups, cfg, KIND), strict=True)
    return nets


def _ones(groups, stage):
    return {g: jax.tree_util.tree_map(np.ones_like, groups[g]["params"])
            for g in COGNITIVE_TRAINED[stage]}


def _port_state(groups, cfg, stage):
    return make_cognitive_state(_port_nets(groups, cfg), cfg, stage,
                                convert.moments_from_jax(_ones(groups, stage), cfg, KIND))


def _jax_state(groups, jcfg, stage):
    t = jcfg.train
    opt = JaxRmsProp(t.rms_decay, t.rms_eps, clip=1.0)
    state = jax_make_state(groups, {g: opt for g in COGNITIVE_TRAINED[stage]})
    return state.replace(opt_state={g: RmsState(jax.tree_util.tree_map(jnp.ones_like, s.sq_avg))
                                    for g, s in state.opt_state.items()})


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    s = cfg.model.image_size
    return (rng.normal(size=(b, cfg.model.num_voxels)).astype(np.float32),
            rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32))


def _noise(key, b, latent):
    """eps, eps_t, z_p as the JAX step draws them from its key."""
    return tuple(np.array(jax.random.normal(k, (b, latent), jnp.float32))
                 for k in jax.random.split(key, 3))


def _rel(got, ref, scale) -> float:
    return float((got.double() - ref.double()).norm()
                 / max(float(scale.double().norm()), 1e-30))


def _compare(jstate, jm, state, m, cfg, start, stage, tol=TOL):
    """Metrics and gates; every parameter, BN running statistic (teacher
    and frozen groups included) and RMSprop moment against the JAX state;
    the frozen groups' parameters bitwise unchanged."""
    for k, r in jm.items():
        assert float(m[k]) == pytest.approx(float(r), rel=tol["loss"], abs=1e-7), k
    ref = convert.from_jax_groups({g: {"params": jstate.params[g],
                                       "batch_stats": jstate.batch_stats[g]}
                                   for g in GROUPS4}, cfg, KIND)
    got = state.nets.state_dict()
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            assert _rel(got[k], r, r) <= tol["stats"], k
        elif k.startswith(FROZEN[stage]) or torch.equal(r, start[k]):
            assert torch.equal(got[k], start[k]), k  # frozen or gated off
        else:
            assert _rel(got[k], r, r - start[k]) <= tol["param"], k
    ref_sq = convert.moments_from_jax({g: jstate.opt_state[g].sq_avg
                                       for g in COGNITIVE_TRAINED[stage]}, cfg, KIND)
    assert sorted(state.opt_state) == sorted(COGNITIVE_TRAINED[stage])
    for g, moments in ref_sq.items():
        for k, r in moments.items():
            assert _rel(state.opt_state[g][k], r, r) <= tol["sq"], f"{g}.{k}"


def _run_both(jcfg, cfg, stage, mode, use_teacher, backward="spliced", steps=3,
              b=8, seed=0, check=(0, 2)):
    """Both packages' step from one state over ``steps`` batches; compares
    after the steps in ``check``. Returns (port state, start state dict)."""
    groups = convert.random_groups(cfg, seed, KIND)
    jstate, state = _jax_state(groups, jcfg, stage), _port_state(groups, cfg, stage)
    jfns = jax_step(jcfg, stage, mode, use_teacher=use_teacher, donate=False,
                    backward=backward)
    fns = make_vgan_cognitive_step(cfg, stage, mode, use_teacher=use_teacher,
                                   backward=backward)
    start = {k: v.clone() for k, v in state.nets.state_dict().items()}
    for i in range(steps):
        fmri, image = _batch(cfg, b, 10 + i)
        key = jax.random.key(100 + i)
        eps, eps_t, z_p = _noise(key, b, cfg.model.latent_dim)
        jstate, jm = jfns.train_step(
            jstate, {"fmri": jnp.asarray(fmri), "image": jnp.asarray(image)}, key,
            jnp.float32(MARGIN), jnp.float32(EQUILIBRIUM), jnp.float32(LAMBDA_MSE))
        state, m = fns.train_step(state, *map(torch.from_numpy, (fmri, image, eps,
                                                                 eps_t, z_p)),
                                  MARGIN, EQUILIBRIUM, LAMBDA_MSE)
        assert (float(m["train_dec"]), float(m["train_dis"])) == (
            float(jm["train_dec"]), float(jm["train_dis"]))
        if i in check:
            _compare(jstate, jm, state, m, cfg, start, stage)
    assert int(state.step) == int(jstate.step) == steps
    return state, start


def _check_case(stage, mode, use_teacher, flags):
    """One case of the stage-II/III matrix: metrics, gates, parameters,
    every group's BN running statistics and the RMSprop moments after one
    step and after three; what must tick ticked: stage II ticks the decoder
    three times (x_tilde, gt_x, x_p) with the teacher, twice without, and
    the teacher with it; stage III ticks the frozen encoder."""
    jcfg, cfg = _configs(flags, flags)
    state, start = _run_both(jcfg, cfg, stage, mode, use_teacher)
    sd = state.nets.state_dict()
    ticked = {p for p in ("encoder.", "decoder.", "discriminator.", "teacher_net.encoder.")
              if all(not torch.equal(sd[k], start[k]) for k in sd
                     if k.startswith(p) and "running" in k)}
    assert ticked == {"encoder.", "decoder.", "discriminator."} | (
        {"teacher_net.encoder."} if stage == 2 and use_teacher else set())
    assert int(sd["decoder.fc.1.num_batches_tracked"]) == (
        9 if stage == 2 and use_teacher else 6)


@pytest.mark.parametrize("flags", [False, True], ids=["flags-off", "kernels"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("use_teacher", [True, False], ids=["teacher", "no-teacher"])
def test_stage2_step_matches_jax(use_teacher, mode, flags):
    """Stage II against the JAX step; ``tests/test_torch_cognitive_stage3.py``
    runs the same check for stage III."""
    _check_case(2, mode, use_teacher, flags)


@pytest.mark.parametrize("stage,mode", [(s, m) for s in (2, 3) for m in MODES])
def test_spliced_equals_naive(stage, mode):
    """Both backwards give the same update (fp32 reassociation: atol 1e-7
    on parameters, whose updates are about 1e-4), except stage-III 'dcgan',
    where the JAX package's own two backwards differ (the spliced one
    drops the decoder's GAN term): the port matches each JAX backward there
    and the gap between them is pinned."""
    _, cfg = _configs()
    groups = convert.random_groups(cfg, 4, KIND)
    fmri, image = (torch.from_numpy(a) for a in _batch(cfg, 6, 8))
    noise = [torch.from_numpy(a) for a in _noise(jax.random.key(9), 6, 16)]
    out = {}
    for backward in ("spliced", "naive"):
        state = _port_state(groups, cfg, stage)
        step = make_vgan_cognitive_step(cfg, stage, mode, backward=backward)
        out[backward] = step.train_step(state, fmri, image, *noise, MARGIN,
                                        EQUILIBRIUM, 0.3)
    (s1, m1), (s2, m2) = out["spliced"], out["naive"]
    sd1, sd2 = s1.nets.state_dict(), s2.nets.state_dict()
    gap = max(float((sd1[k] - v).abs().max()) for k, v in sd2.items())
    if (stage, mode) == (3, "dcgan"):
        # the decoder's GAN term, -(1 - lambda) (bce_orig + bce_sampled), is
        # in the naive update only: 16.6% of its L2 norm on the worst tensor
        # (1.3e-4 on single elements, at lr 1e-4)
        start = _port_state(groups, cfg, stage).nets.state_dict()
        rel = max(_rel(sd1[k], sd2[k], sd2[k] - start[k]) for k in sd2
                  if k.startswith("decoder.") and k.endswith("weight"))
        assert 0.15 <= rel <= 0.18 and 1e-4 <= gap <= 2e-4, (rel, gap)
        jcfg, _ = _configs()
        for backward in ("spliced", "naive"):
            _run_both(jcfg, cfg, 3, "dcgan", False, backward=backward, steps=1,
                      check=(0,))
        return
    for k in m1:
        assert float(m1[k]) == pytest.approx(float(m2[k]), rel=1e-6), k
    assert gap <= 1e-7


class _Count:
    """Counts the calls of one wrapper (the CPU takes its plain version)."""

    def __init__(self, monkeypatch, module, name):
        self.n, orig = 0, getattr(module, name)

        def call(*args):
            self.n += 1
            return orig(*args)

        monkeypatch.setattr(module, name, call)


@pytest.mark.parametrize("stage,want", [(2, (8, 8, 4)), (3, (11, 11, 12))])
def test_kernel_calls_per_step(monkeypatch, stage, want):
    """Calls of the BN-backward wrappers and the weight-grad wrappers per
    'vae-gan' step with both kernel flags on (on the card, one launch each).
    Stage II: the discriminator's C basis (3 BN, 4 weight grads), its B
    basis to x_tilde (2 BN) and the decoder back to z (3 BN, no weight
    grad). Stage III: C basis 3 BN and 4, B basis 2 BN, the decoder's two
    passes 3 BN and 4 weight grads each. Fused stage III with
    ``pallas_bn`` off: one decoder pass, 4 + 4 weight grads."""
    counts = [_Count(monkeypatch, port_bn, "bn_bwd_reduce"),
              _Count(monkeypatch, port_bn, "bn_bwd_apply"),
              _Count(monkeypatch, port_dw, "conv2d_dw"),
              _Count(monkeypatch, port_dw, "conv2d_transpose_dw")]
    for cfg, expect in ((_configs(True, True)[1], want),
                        (_configs(False, True, fused=True)[1],
                         (0, 0, 4 + 4 * (stage == 3)))):
        state = _port_state(convert.random_groups(cfg, 0, KIND), cfg, stage)
        step = make_vgan_cognitive_step(cfg, stage)
        fmri, image = _batch(cfg, 4, 0)
        noise = _noise(jax.random.key(0), 4, 16)
        for c in counts:
            c.n = 0
        step.train_step(state, *map(torch.from_numpy, (fmri, image, *noise)),
                        MARGIN, EQUILIBRIUM, LAMBDA_MSE)
        assert (counts[0].n, counts[1].n, counts[2].n + counts[3].n) == expect


def test_step_factory_checks():
    """Stages 2 and 3 only (modes and ``alt_backward``:
    ``tests/test_torch_modes.py``)."""
    _, cfg = _configs()
    for stage in (1, 4):
        with pytest.raises(ValueError, match="stage must be 2 or 3"):
            make_vgan_cognitive_step(cfg, stage)


def test_eval_and_generate_match_jax():
    """Running statistics; z = mu or mu + eps * exp(logvar / 2); the prior
    draws of the JAX ``generate_step`` handed to the port's (atol 1e-5)."""
    jcfg, cfg = _configs()
    groups = convert.random_groups(cfg, 5, KIND)
    jstate, state = _jax_state(groups, jcfg, 3), _port_state(groups, cfg, 3)
    jfns, fns = jax_step(jcfg, 3, donate=False), make_vgan_cognitive_step(cfg, 3)
    fmri = _batch(cfg, 4, 1)[0]
    key = jax.random.key(3)
    for rng, eps in ((None, None), (key, np.array(jax.random.normal(key, (4, 16))))):
        got = fns.eval_step(state, torch.from_numpy(fmri),
                            None if eps is None else torch.from_numpy(eps))
        ref = jfns.eval_step(jstate, {"fmri": jnp.asarray(fmri)}, rng)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    z_p = np.array(jax.random.normal(key, (5, 16), jnp.float32))
    np.testing.assert_allclose(fns.generate_step(state, torch.from_numpy(z_p)).numpy(),
                               np.asarray(jfns.generate_step(jstate, key, 5)), atol=1e-5)


# ---------------------------------------------------------------- weights


def test_random_groups_and_converter_equal_export_state_dict():
    """The ``"vae-gan-cognitive"`` kind gives ``export_state_dict``'s arrays
    key for key, ``teacher_net.*`` included; without the teacher, the
    student's keys only; a missing required group raises."""
    jcfg, cfg = _configs()
    groups = convert.random_groups(cfg, 1, KIND)
    eval_groups = convert.random_groups(cfg, 1)
    for g in ("encoder", "decoder"):  # the eval kind's groups of the same seed
        jax.tree_util.tree_map(np.testing.assert_array_equal, groups[g], eval_groups[g])
    for gs in (groups, {g: groups[g] for g in GROUPS4[:3]}):
        ref = export_state_dict(gs, jcfg, kind=KIND)
        got = convert.from_jax_groups(gs, cfg, KIND)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    assert any(k.startswith("teacher_net.discriminator.") for k in got) is False
    with pytest.raises(KeyError, match="discriminator"):
        convert.from_jax_groups({g: groups[g] for g in ("encoder", "decoder")}, cfg, KIND)
    moments = convert.moments_from_jax({"teacher_encoder": groups["teacher_encoder"]["params"]},
                                       cfg, KIND)
    assert sorted(moments["teacher_encoder"]) == sorted(
        VaeGanCognitiveTrain(cfg).group("teacher_encoder"))


def test_reference_pth_loads_strictly(tmp_path):
    """A reference-layout stage-2 ``.pth`` (``teacher_net.*`` included, as
    ``torch.save`` writes the reference's shared modules) loads strictly
    into the train module, whose own state dict lists the shared decoder
    and discriminator under both prefixes; the inference module still
    loads it through ``load_pth``. Without the teacher group the strict
    load names the missing ``teacher_net.encoder.*`` keys."""
    jcfg, cfg = _configs()
    groups = convert.random_groups(cfg, 2, KIND)
    path = tmp_path / "stage2.pth"
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in export_state_dict(groups, jcfg, kind=KIND).items()}, path)
    nets = VaeGanCognitiveTrain(cfg)
    nets.load_state_dict(convert.load_train_pth(str(path)), strict=True)
    assert nets.teacher_net.decoder is nets.decoder
    assert nets.teacher_net.discriminator is nets.discriminator
    sd = nets.state_dict()
    ref = convert.from_jax_groups(groups, cfg, KIND)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k
    model = VaeGanCognitive(cfg.model)
    model.load_state_dict(convert.load_pth(str(path)), strict=True)
    with pytest.raises(RuntimeError, match="teacher_net.encoder"):  # no teacher group
        VaeGanCognitiveTrain(cfg).load_state_dict(convert.from_jax_groups(
            {g: groups[g] for g in GROUPS4[:3]}, cfg, KIND), strict=True)


def test_init_cognitive_grafts_the_stage1_triplet():
    """A fresh cognitive encoder from the seed (the reference init); the
    decoder, discriminator and teacher encoder copied from stage I
    (``fmri_tpu/train/stages.py:79-85``); optimizers for the trained groups
    only, clamping at 1 whatever ``grad_clip`` says."""
    cfg = presets.get_config("tiny")
    stage1 = init_vaegan(cfg, seed=1)
    nets = init_cognitive(cfg, stage1, seed=2)
    sd, ref = nets.state_dict(), stage1.state_dict()
    for k, v in ref.items():
        if not k.startswith("encoder."):
            assert torch.equal(sd[k], v) and torch.equal(sd["teacher_net." + k], v), k
        assert torch.equal(sd["teacher_net." + k], v), k
    w = sd["encoder.fc1.0.weight"]
    bound = (3.0 * w.shape[1]) ** -0.5
    assert 0.9 * bound < float(w.abs().max()) <= bound
    assert torch.equal(init_cognitive(cfg, stage1, seed=2).state_dict()["encoder.fc1.0.weight"], w)
    assert isinstance(nets.teacher_net, VaeGan)
    for stage in (2, 3):
        state = make_cognitive_state(copy.deepcopy(nets), cfg, stage)
        assert sorted(state.opt_state) == sorted(COGNITIVE_TRAINED[stage])
