"""The port's WAE/GAN stage-I step (``fmri_tpu_torch/train/steps_wae.py::
make_wae_stage1_step``) against the JAX package's ``make_wae_stage1_step``
on the CPU at ``tiny``; the WAE weights (converter kinds, the latent
discriminator); and the ``--family wae`` / ``--family wae-vgan`` inference
CLI. The helpers here are shared by ``tests/test_torch_wae_cognitive.py`` and
``tests/test_torch_wae_vgan.py``.

Both packages start from the same seeded numpy groups (``random_groups``;
the port loads them through ``from_jax_groups``), the same images and the
JAX step's own noise draws, injected into the port. Adam starts with its
second moments at ones (first moments and count at zero) on both sides:
from zero moments the first update is lr * g / (|g| + eps), about
lr * sign(g), which flips on rounding noise wherever |g| sits at rounding
level; from nu = 1 the update is linear in g, so the two packages differ by
the rounding of the gradient and no more. The first moment after one step
is (1 - b1) * g, so holding it holds the gradient before the update.

Tolerances (``TOL``), after step 1 and after step 3: losses within 1e-6
relative; per tensor, the L2 norm of the port's difference from the JAX
value relative to how far the JAX step moved the parameter (1e-3), or to
the JAX value for BN running statistics (1e-5), Adam's first moments (1e-3:
they are gradients) and second moments (1e-5); Adam's count exactly. That
is fp32 rounding at ``tiny`` (the measured gaps are a quarter of these or
less). ``num_batches_tracked`` is held exactly against the ticks the
reference's forwards make.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmri_tpu.checkpoints.torch_import import export_state_dict
from fmri_tpu.configs import presets as jax_presets
from fmri_tpu.data.synthetic import synthetic_images, synthetic_pairs
from fmri_tpu.eval import evaluate as jax_eval
from fmri_tpu.models.nets import LatentDiscriminator as JaxLatentD
from fmri_tpu.train import Adam as JaxAdam
from fmri_tpu.train import init_latent_disc as jax_init_latent_disc
from fmri_tpu.train import make_state as jax_make_state
from fmri_tpu.train import make_wae_cognitive_step as jax_cognitive_step
from fmri_tpu.train import make_wae_stage1_step as jax_stage1_step
from fmri_tpu.train import make_wae_vgan_step as jax_vgan_step
from fmri_tpu.train.optim import AdamState as JaxAdamState
from fmri_tpu.train.optim import RmsState
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.configs import presets
from fmri_tpu_torch.eval import inference
from fmri_tpu_torch.eval.steps import VaeGanVisual, WaeCognitive, WaeVisual
from fmri_tpu_torch.models.nets import LatentDiscriminator
from fmri_tpu_torch.ops import bn as port_bn
from fmri_tpu_torch.ops import dw as port_dw
from fmri_tpu_torch.train.optim import AdamState
from fmri_tpu_torch.train.state import (
    WAE_GROUPS, WaeGan, WaeGanCognitiveTrain, init_wae, init_wae_cognitive,
    make_wae_state,
)
from fmri_tpu_torch.train.steps_wae import make_wae_stage1_step

TOL = dict(loss=1e-6, param=1e-3, stats=1e-5, mu=1e-3, nu=1e-5)
MARGIN, EQUILIBRIUM, LAMBDA_MSE = 0.35, 0.68, 1e-6


def configs(pallas_bn=False, pallas_backward=False, fused=False, alt=False):
    """(JAX config, port config) at tiny with the given flags."""
    kw = dict(pallas_bn=pallas_bn, pallas_backward=pallas_backward,
              fused_decoder_batch=fused, alt_backward=alt)
    return tuple(dataclasses.replace(m.get_config("tiny"), model=dataclasses.replace(
        m.get_config("tiny").model, **kw)) for m in (jax_presets, presets))


def warm_adam(params):
    """An Adam state over a JAX params tree: mu 0, nu 1, count 0."""
    return JaxAdamState(jax.tree_util.tree_map(np.zeros_like, params),
                        jax.tree_util.tree_map(np.ones_like, params), np.int32(0))


def jax_state(groups, trained, opt_of):
    """A JAX TrainState over numpy ``groups`` with warmed moments for the
    ``trained`` groups: Adam (``warm_adam``) or RMSprop (``sq_avg`` 1)."""
    state = jax_make_state(groups, {g: opt_of(g) for g in trained})
    opt_state = {}
    for g, s in state.opt_state.items():
        if isinstance(s, RmsState):
            opt_state[g] = RmsState(jax.tree_util.tree_map(jnp.ones_like, s.sq_avg))
        else:
            opt_state[g] = JaxAdamState(*(jax.tree_util.tree_map(jnp.asarray, t)
                                          for t in warm_adam(groups[g]["params"])))
    return state.replace(opt_state=opt_state)


def port_moments(groups, trained, cfg, kind, adam=True):
    """The same warmed moments in the port's layout."""
    trees = {g: warm_adam(groups[g]["params"]) if adam
             else jax.tree_util.tree_map(np.ones_like, groups[g]["params"])
             for g in trained}
    return convert.moments_from_jax(trees, cfg, kind)


def rel(got, ref, scale) -> float:
    return float((got.double() - ref.double()).norm()
                 / max(float(scale.double().norm()), 1e-30))


def compare(jstate, jm, state, m, cfg, kind, start, frozen=(), tol=TOL):
    """Metrics; every parameter and BN running statistic against the JAX
    state (the frozen prefixes' parameters bitwise unchanged, and a tensor
    that the JAX step left as it was, bitwise too); every moment and count."""
    assert sorted(m) == sorted(jm)
    for k, r in jm.items():
        assert float(m[k]) == pytest.approx(float(r), rel=tol["loss"], abs=1e-7), k
    groups = {g: {"params": jstate.params[g], "batch_stats": jstate.batch_stats[g]}
              for g in jstate.params}
    ref = convert.from_jax_groups(groups, cfg, kind)
    got = state.nets.state_dict()
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            assert rel(got[k], r, r) <= tol["stats"], k
        elif k.startswith(tuple(frozen)) or torch.equal(r, start[k]):
            assert torch.equal(got[k], start[k]), k
        else:
            assert rel(got[k], r, r - start[k]) <= tol["param"], k
    assert sorted(state.opt_state) == sorted(jstate.opt_state)
    ref_m = convert.moments_from_jax(dict(jstate.opt_state), cfg, kind)
    for g, r in ref_m.items():
        s = state.opt_state[g]
        if isinstance(r, AdamState):
            assert int(s.count) == int(r.count), g
            for name, got_t, ref_t in (("mu", s.mu, r.mu), ("nu", s.nu, r.nu)):
                for k, v in ref_t.items():
                    assert rel(got_t[k], v, v) <= tol[name], f"{g}.{name}.{k}"
        else:
            for k, v in r.items():
                assert rel(s[k], v, v) <= tol["nu"], f"{g}.{k}"


def ticks(state, prefix: str) -> set:
    """The ``num_batches_tracked`` values of the BatchNorms under ``prefix``."""
    return {int(v) for k, v in state.nets.state_dict().items()
            if k.startswith(prefix) and k.endswith("num_batches_tracked")}


class Count:
    """Counts the calls of one wrapper (the CPU takes its plain version)."""

    def __init__(self, monkeypatch, module, name):
        self.n, orig = 0, getattr(module, name)

        def call(*args):
            self.n += 1
            return orig(*args)

        monkeypatch.setattr(module, name, call)


def count_kernel_calls(monkeypatch):
    """Counters of the BN-backward and weight-grad wrappers; ``read()`` gives
    (reduce, apply, weight grads) since the last ``reset()``."""
    counts = [Count(monkeypatch, port_bn, "bn_bwd_reduce"),
              Count(monkeypatch, port_bn, "bn_bwd_apply"),
              Count(monkeypatch, port_dw, "conv2d_dw"),
              Count(monkeypatch, port_dw, "conv2d_transpose_dw")]

    class Counts:
        @staticmethod
        def reset():
            for c in counts:
                c.n = 0

        @staticmethod
        def read():
            return counts[0].n, counts[1].n, counts[2].n + counts[3].n

    return Counts


def images(cfg, b, seed):
    s = cfg.model.image_size
    return np.random.default_rng(seed).uniform(-1, 1, (b, s, s, 3)).astype(np.float32)


# ------------------------------------------------------------- stage I

KIND = "wae-gan"


def _stage1_states(groups, jcfg, cfg):
    t = jcfg.train
    jstate = jax_state(groups, WAE_GROUPS, lambda g: JaxAdam(t.adam_b1, t.adam_b2))
    nets = WaeGan(cfg)
    nets.load_state_dict(convert.from_jax_groups(groups, cfg, KIND), strict=True)
    return jstate, make_wae_state(nets, cfg, port_moments(groups, WAE_GROUPS, cfg, KIND))


def _z_fake(key, b, latent, sigma=0.5):
    """z_fake as the JAX stage-I step draws it from its key (``steps_wae.py:69``)."""
    return np.array(sigma * jax.random.normal(key, (b, latent), jnp.float32))


@pytest.mark.parametrize("flags", [False, True], ids=["flags-off", "kernels"])
@pytest.mark.parametrize("backward", ["spliced", "naive"])
def test_stage1_step_matches_jax(backward, flags):
    """After steps 1 and 3 (``TOL``): metrics, parameters, BN statistics,
    Adam moments and counts; the encoder's BatchNorms tick twice per step
    (the reference's phase-2 recompute), the decoder's once. The JAX step
    runs with its kernel flags off; the port's flags, where on, take the
    plain versions on the CPU."""
    jcfg, cfg = configs()
    _, cfg_port = configs(flags, flags)
    groups = convert.random_groups(cfg, 0, KIND)
    jstate, state = _stage1_states(groups, jcfg, cfg_port)
    jfns = jax_stage1_step(jcfg, donate=False, backward=backward)
    fns = make_wae_stage1_step(cfg_port, backward=backward)
    start = {k: v.clone() for k, v in state.nets.state_dict().items()}
    for i in range(3):
        x = images(cfg, 8, 10 + i)
        key = jax.random.key(100 + i)
        jstate, jm = jfns.train_step(jstate, jnp.asarray(x), key)
        state, m = fns.train_step(state, torch.from_numpy(x),
                                  torch.from_numpy(_z_fake(key, 8, 16)))
        if i in (0, 2):
            compare(jstate, jm, state, m, cfg, KIND, start)
    assert ticks(state, "encoder.") == {6} and ticks(state, "decoder.") == {3}
    assert int(state.step) == int(jstate.step) == 3


def test_stage1_spliced_equals_naive():
    """Both backwards give the same update (atol 1e-7 on parameters, whose
    updates are about 1e-4) and the same metrics (1e-6)."""
    _, cfg = configs()
    groups = convert.random_groups(cfg, 4, KIND)
    x = torch.from_numpy(images(cfg, 6, 3))
    z = torch.from_numpy(_z_fake(jax.random.key(5), 6, 16))
    out = {}
    for backward in ("spliced", "naive"):
        nets = WaeGan(cfg)
        nets.load_state_dict(convert.from_jax_groups(groups, cfg, KIND), strict=True)
        state = make_wae_state(nets, cfg, port_moments(groups, WAE_GROUPS, cfg, KIND))
        out[backward] = make_wae_stage1_step(cfg, backward=backward).train_step(state, x, z)
    (s1, m1), (s2, m2) = out["spliced"], out["naive"]
    for k in m1:
        assert float(m1[k]) == pytest.approx(float(m2[k]), rel=1e-6), k
    sd2 = s2.nets.state_dict()
    for k, v in s1.nets.state_dict().items():
        np.testing.assert_allclose(v.numpy(), sd2[k].numpy(), rtol=0, atol=1e-7, err_msg=k)


def test_stage1_kernel_calls_per_step(monkeypatch):
    """Calls of the BN-backward and weight-grad wrappers per stage-I step
    with both kernel flags on (on the card, one launch each): one encoder
    backward (3 BN, 3 weight grads) and one decoder backward (3 BN, 4), in
    either backward."""
    counts = count_kernel_calls(monkeypatch)
    _, cfg = configs(True, True)
    groups = convert.random_groups(cfg, 0, KIND)
    for backward in ("spliced", "naive"):
        _, state = _stage1_states(groups, configs()[0], cfg)
        counts.reset()
        make_wae_stage1_step(cfg, backward=backward).train_step(
            state, torch.from_numpy(images(cfg, 4, 0)), torch.zeros((4, 16)))
        assert counts.read() == (6, 6, 7), backward


def test_eval_and_generate_match_jax():
    """The WAE eval decodes mu (a given eps is ignored, as the JAX
    ``eval_step`` takes no sample); generate decodes the prior draws
    (atol 1e-5)."""
    jcfg, cfg = configs()
    groups = convert.random_groups(cfg, 5, KIND)
    jstate, state = _stage1_states(groups, jcfg, cfg)
    jfns, fns = jax_stage1_step(jcfg, donate=False), make_wae_stage1_step(cfg)
    x = images(cfg, 4, 1)
    ref = np.asarray(jfns.eval_step(jstate, jnp.asarray(x)))
    for eps in (None, torch.ones((4, 16))):
        np.testing.assert_allclose(fns.eval_step(state, torch.from_numpy(x), eps).numpy(),
                                   ref, atol=1e-5)
    key = jax.random.key(3)
    z_p = np.array(jax.random.normal(key, (5, 16), jnp.float32))
    np.testing.assert_allclose(fns.generate_step(state, torch.from_numpy(z_p)).numpy(),
                               np.asarray(jfns.generate_step(jstate, key, 5)), atol=1e-5)


# ------------------------------------------------------------- weights


@pytest.mark.parametrize("kind", ["wae-gan", "wae-gan-cognitive"])
def test_converter_equals_export_state_dict(kind):
    """The WAE kinds give ``export_state_dict``'s arrays key for key (the
    latent D under ``discriminator.``); the cognitive kind's optional
    teacher adds ``teacher_encoder.*``; a missing group raises."""
    jcfg, cfg = configs()
    groups = convert.random_groups(cfg, 1, kind)
    student = {g: groups[g] for g in ("encoder", "decoder", "latent_disc")}
    ref = export_state_dict(student, jcfg, kind=kind)
    got = convert.from_jax_groups(student, cfg, kind)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    full = convert.from_jax_groups(groups, cfg, kind)
    extra = sorted(set(full) - set(got))
    if kind == "wae-gan":
        assert extra == []
    else:
        assert extra and all(k.startswith("teacher_encoder.") for k in extra)
    with pytest.raises(KeyError, match="latent_disc"):
        convert.from_jax_groups({g: groups[g] for g in ("encoder", "decoder")}, cfg, kind)


def test_dual_gan_kind_and_adam_moments():
    """``"wae-vgan"``: the stage-I triplet's keys and ``latent_disc.*``, the
    triplet's arrays equal to ``"vae-gan"``'s of the same seed; Adam
    moments carry mu, nu and count through the weights' permutations."""
    _, cfg = configs()
    groups = convert.random_groups(cfg, 2, "wae-vgan")
    triplet = convert.random_groups(cfg, 2, "vae-gan")
    sd = convert.from_jax_groups(groups, cfg, "wae-vgan")
    ref = convert.from_jax_groups(triplet, cfg, "vae-gan")
    assert sorted(set(sd) - set(ref)) == sorted(
        f"latent_disc.main.{i}.{p}" for i in (0, 2, 4, 6, 8) for p in ("weight", "bias"))
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k
    state = JaxAdamState(groups["latent_disc"]["params"],
                         jax.tree_util.tree_map(lambda a: 2 * a, groups["latent_disc"]["params"]),
                         np.int32(7))
    m = convert.moments_from_jax({"latent_disc": state}, cfg, "wae-vgan")["latent_disc"]
    assert isinstance(m, AdamState) and int(m.count) == 7 and m.count.dtype == torch.int32
    for k, v in m.mu.items():
        assert torch.equal(v, sd[f"latent_disc.{k}"]) and torch.equal(m.nu[k], 2 * v), k


@pytest.mark.parametrize("scheme", ["normal", "uniform"])
def test_latent_discriminator_matches_jax(scheme):
    """The port's LatentDiscriminator on the JAX module's own weights
    (``init_latent_disc``) gives its scores (atol 1e-6, fp32 and 2e-3 with
    bf16 operands); the port's init draws N(0, 0.01) or the reference
    U(-a, a), a = 1/sqrt(3 fan_in), with zero biases."""
    for dtype, atol in ((None, 1e-6), ("bfloat16", 2e-3)):
        jcfg, cfg = (dataclasses.replace(c, model=dataclasses.replace(
            c.model, compute_dtype=dtype)) for c in configs())
        v = jax_init_latent_disc(jax.random.key(0), jcfg, init_scheme=scheme)
        z = np.random.default_rng(0).normal(size=(6, 16)).astype(np.float32)
        ref = JaxLatentD(jcfg.model, init_scheme=scheme).apply(
            {"params": v["params"]}, jnp.asarray(z))
        d = LatentDiscriminator(cfg.model)
        d.load_state_dict({k[len("discriminator."):]: t for k, t in convert.from_jax_groups(
            {"encoder": convert.random_groups(cfg, 0, KIND)["encoder"],
             "decoder": convert.random_groups(cfg, 0, KIND)["decoder"],
             "latent_disc": v}, cfg, KIND).items() if k.startswith("discriminator.")})
        with torch.no_grad():
            np.testing.assert_allclose(d(torch.from_numpy(z)).numpy(), np.asarray(ref),
                                       atol=atol)
    w = LatentDiscriminator(cfg.model).init_weights(scheme).main[2].weight.detach()
    if scheme == "normal":
        assert 0.007 < float(w.std()) < 0.013
    else:
        a = (3.0 * w.shape[1]) ** -0.5
        assert 0.9 * a < float(w.abs().max()) <= a
    with pytest.raises(ValueError, match="init scheme"):
        LatentDiscriminator(cfg.model).init_weights("xavier")


def test_init_wae_models():
    """Fresh WAE models from a seed: the latent D takes the "uniform"
    re-init in stage I and the "normal" ctor init in the cognitive stages,
    whose decoder and teacher come from the stage-I model."""
    cfg = presets.get_config("tiny")
    stage1 = init_wae(cfg, seed=1)
    w = stage1.discriminator.main[0].weight
    assert float(w.abs().max()) <= (3.0 * w.shape[1]) ** -0.5
    nets = init_wae_cognitive(cfg, stage1, seed=2)
    sd, ref = nets.state_dict(), stage1.state_dict()
    for k, v in ref.items():
        if k.startswith("decoder."):
            assert torch.equal(sd[k], v), k
        if k.startswith("encoder."):
            assert torch.equal(sd["teacher_" + k], v), k
    assert float(nets.discriminator.main[0].weight.std()) < 0.02
    assert sorted(WaeGanCognitiveTrain(cfg).group("latent_disc")) == sorted(
        nets.discriminator.state_dict())


# ------------------------------------------------------------- inference CLI


def _summary(out):
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f)


def _cli(pth, out, *args):
    assert inference.main(["--preset", "tiny", "--ckpt", pth, "--synthetic-n", "40",
                           "--batch-size", "8", "-o", out, "--device", "cpu",
                           *args]) == 0
    return _summary(out)


def _hold_summary(summary, ref_r, ref_t):
    ref = jax_eval.quality_metrics(ref_r, ref_t, with_is=False)
    for k in ref:
        assert summary[k] == pytest.approx(ref[k], abs=1e-5), k
    scores = jax_eval.objective_scores(ref_r, ref_t)
    for k in ("pcc", "ssim"):
        np.testing.assert_allclose(summary["objective"][k], scores[k], atol=1.0 / 8 + 1e-12)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_inference_cli_wae(tmp_path, stage):
    """``--family wae --stage 1|2|3`` from a ``.pth`` that the JAX package's
    ``export_state_dict`` writes (``"wae-gan"`` / ``"wae-gan-cognitive"``):
    the metrics and n-way fractions of the JAX ``eval_step`` over the same
    held-out examples (1e-5, 1/N), reconstructions within 1e-5; ``--sample``
    changes nothing, as the JAX WAE eval takes no sample."""
    jcfg, cfg = configs()
    kind = "wae-gan" if stage == 1 else "wae-gan-cognitive"
    groups = {g: v for g, v in convert.random_groups(cfg, 3, kind).items()
              if g != "teacher_encoder"}
    pth = str(tmp_path / "wae.pth")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in export_state_dict(groups, jcfg, kind=kind).items()}, pth)
    runs = [_cli(pth, str(tmp_path / f"out{i}"), "--family", "wae", "--stage", str(stage),
                 *flag) for i, flag in enumerate(([], ["--sample"]))]
    assert runs[0]["num_images"] == 8 and runs[0] == {**runs[1], "checkpoint": pth}
    from torch_port_helpers import jax_state as eval_state

    if stage == 1:
        data = {"image": synthetic_images(40, 16, seed=0)[0][:8]}
        step = jax_stage1_step(jcfg, donate=False).eval_step
        model, x = WaeVisual(cfg.model), torch.from_numpy(2.0 * data["image"] - 1.0)
    else:
        pairs = synthetic_pairs(40, 16, cfg.model.num_voxels, seed=0)
        data = {k: pairs[k][:8] for k in ("fmri", "image")}
        step = jax_cognitive_step(jcfg, stage, donate=False).eval_step
        model, x = WaeCognitive(cfg.model), torch.from_numpy(data["fmri"])
    ref_r, ref_t = jax_eval.reconstruct_dataset(
        step, eval_state(groups), [data], data_kind="image" if stage == 1 else "pair")
    _hold_summary(runs[0], ref_r, ref_t)
    model.load_state_dict(convert.load_pth(pth), strict=True)
    np.testing.assert_allclose(model.reconstruct(x, torch.ones((8, 16))).numpy() * 0.5 + 0.5,
                               ref_r, atol=1e-5)


def test_inference_cli_wae_vgan(tmp_path):
    """``--family wae-vgan`` (``--stage`` ignored, as the JAX CLI ignores
    it) from a ``"wae-vgan"`` ``.pth``: image -> image through the encoder
    and decoder, the JAX WAE/Dual-GAN ``eval_step``'s metrics (1e-5); with
    ``--sample`` the latent is reparameterised, so the result moves."""
    jcfg, cfg = configs()
    groups = convert.random_groups(cfg, 6, "wae-vgan")
    pth = str(tmp_path / "wae_vgan.pth")
    torch.save(convert.from_jax_groups(groups, cfg, "wae-vgan"), pth)
    summary = _cli(pth, str(tmp_path / "a"), "--family", "wae-vgan", "--stage", "3")
    data = {"image": synthetic_images(40, 16, seed=0)[0][:8]}
    from torch_port_helpers import jax_state as eval_state

    step = jax_vgan_step(jcfg, donate=False).eval_step
    ref_r, ref_t = jax_eval.reconstruct_dataset(step, eval_state(groups), [data],
                                                data_kind="image")
    _hold_summary(summary, ref_r, ref_t)
    sampled = _cli(pth, str(tmp_path / "b"), "--family", "wae-vgan", "--sample")
    assert sampled["mse"] != summary["mse"]
    model = VaeGanVisual(cfg.model)
    model.load_state_dict(convert.load_pth(pth), strict=True)
    assert set(convert.load_train_pth(pth)) - set(model.state_dict()) == {
        k for k in convert.load_train_pth(pth)
        if k.startswith(("discriminator.", "latent_disc."))}
