"""The port's ablation steps (``fmri_tpu_torch/train/steps_exp.py``) against
the JAX package's (``fmri_tpu/train/steps_exp.py``) on the CPU at ``tiny``.

Both packages start from the same seeded numpy groups (``random_groups`` of
``"exp-decoder"``, ``"vae-gan-cognitive"`` without the teacher, and
``"dcgan"``; the port loads them through ``from_jax_groups``), the same
fMRI and images, and the JAX step's own noise, split from its key as the
JAX step splits it and injected into the port. Moments start warm on both
sides: RMSprop's at ones, Adam's second moments at ones (first moments and
count at zero), so an update is linear in the gradient
(``tests/test_torch_wae.py``). The port runs with both kernel flags on
(the kernels' plain versions on the CPU) against the JAX step with them
off, except the supervised decoder, where the JAX step runs its Pallas
kernels too (interpret mode).

Tolerances (``test_torch_wae.TOL``), after step 1 and after step 3: losses
1e-6 relative; per tensor, the L2 norm of the port's difference from the
JAX value relative to how far the JAX step moved the parameter (1e-3), or
to the JAX value for BN running statistics (1e-5), RMSprop moments and
Adam's second moments (1e-5), Adam's first moments (1e-3); Adam's count
exactly; a tensor the JAX step left as it was, and a frozen group, bitwise.

The reference quirks each case pins (``fmri_tpu/train/steps_exp.py``):
``exp_vae``'s constant gates (the discriminator's parameters and moments
bitwise unchanged while its BatchNorm ticks) and its unclamped decoder
(``lambda_mse`` 1, so the decoder's gradients pass 1); ``exp_dcgan_stage1``'s
gate on the script's own means and the discriminator loss in the decoder's
gradient, in one case where the discriminator trains and one where, on
those means, it does not (a discriminator biased to score 0.9, where the
family's gate would train both); ``exp_dcgan_stage2``'s frozen encoder,
whose BatchNorm ticks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmri_tpu.train.optim import Adam as JaxAdam
from fmri_tpu.train.optim import RmsProp as JaxRmsProp
from fmri_tpu.train.steps_exp import (
    make_cognitive_scratch_step as jax_scratch_step,
    make_dcgan_stage1_step as jax_dcgan1_step,
    make_dcgan_stage2_step as jax_dcgan2_step,
    make_supervised_decoder_step as jax_decoder_step,
)
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.train import steps_exp
from fmri_tpu_torch.train.state import CognitiveVaeGan, DcGan, ExpDecoder, make_state
from test_torch_wae import compare, configs, images, jax_state, port_moments
from torch_port_helpers import one_torch_thread  # noqa: F401

MARGIN, EQUILIBRIUM = 0.35, 0.68
B = 8


@pytest.fixture(autouse=True)
def _threads(one_torch_thread):
    yield


def _flags():
    """(JAX config, flags off; port config, both kernel flags on)."""
    return configs()[0], configs(True, True)[1]


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, cfg.model.num_voxels)).astype(np.float32),
            images(cfg, B, seed + 100))


def _normals(key, n, latent):
    keys = [key] if n == 1 else jax.random.split(key, n)
    return [np.array(jax.random.normal(k, (B, latent), jnp.float32)) for k in keys]


def _states(groups, jcfg, cfg, kind, module, opts, adam=False):
    """The JAX state (warm moments for the groups of ``opts``) and the
    port's, loaded from the same groups."""
    jstate = jax_state(groups, list(opts), lambda g: opts[g])
    nets = module(cfg)
    nets.load_state_dict(convert.from_jax_groups(groups, cfg, kind), strict=True)
    state = make_state(nets, {g: None for g in opts},
                       port_moments(groups, list(opts), cfg, kind, adam=adam))
    return jstate, state


def _run(jstate, state, jtrain, train, feed, cfg, kind, frozen=(), steps=3):
    """Both steps over ``steps`` batches; gates equal every step, everything
    compared after steps 1 and 3. ``feed(i)`` -> (JAX args, port args).
    Returns (start state dict, port state, metrics per step, JAX state)."""
    start = {k: v.clone() for k, v in state.nets.state_dict().items()}
    history = []
    for i in range(steps):
        jargs, args = feed(i)
        jstate, jm = jtrain(jstate, *jargs)
        state, m = train(state, *args)
        for g in ("train_dec", "train_dis"):
            if g in jm:
                assert float(m[g]) == float(jm[g]), (i, g)
        if i in (0, steps - 1):
            compare(jstate, jm, state, m, cfg, kind, start, frozen)
        history.append({k: float(v) for k, v in m.items()})
    return start, state, history, jstate


def test_supervised_decoder_matches_jax():
    """exp_decoder with the kernel flags on in both packages (the JAX
    Pallas kernels in interpret mode): MSE, Adam(0.9, 0.999) at lr 0.01."""
    jcfg, cfg = configs(True, True)
    kind = "exp-decoder"
    groups = convert.random_groups(cfg, 0, kind)
    jstate, state = _states(groups, jcfg, cfg, kind, ExpDecoder,
                            {"decoder": JaxAdam(0.9, 0.999)}, adam=True)
    jfns = jax_decoder_step(jcfg, donate=False)
    fns = steps_exp.make_supervised_decoder_step(cfg)
    assert fns.generate_step is None and jfns.generate_step is None

    def feed(i):
        fmri, image = _batch(cfg, i)
        return (({"fmri": jnp.asarray(fmri), "image": jnp.asarray(image)},
                 jax.random.key(i)), (torch.from_numpy(fmri), torch.from_numpy(image)))

    _, state, _, jstate = _run(jstate, state, jfns.train_step, fns.train_step, feed, cfg,
                               kind)
    assert int(state.opt_state["decoder"].count) == 3
    fmri = _batch(cfg, 9)[0]  # eval: running statistics (atol 1e-5)
    np.testing.assert_allclose(fns.eval_step(state, torch.from_numpy(fmri)).numpy(),
                               np.asarray(jfns.eval_step(jstate, {"fmri": fmri})), atol=1e-5)


def _scratch_case(mode, lambda_mse, seed):
    jcfg, cfg = _flags()
    kind = "vae-gan-cognitive"
    groups = convert.random_groups(cfg, seed, kind)
    del groups["teacher_encoder"]
    opt = JaxRmsProp(jcfg.train.rms_decay, jcfg.train.rms_eps, clip=1.0)
    jstate, state = _states(groups, jcfg, cfg, kind, CognitiveVaeGan,
                            {g: opt for g in ("encoder", "decoder", "discriminator")})
    jfns = jax_scratch_step(jcfg, mode, donate=False)
    fns = steps_exp.make_cognitive_scratch_step(cfg, mode)

    def feed(i):
        fmri, image = _batch(cfg, 10 + i)
        key = jax.random.key(100 + i)
        eps, z_p = _normals(key, 2, cfg.model.latent_dim)
        gate = (MARGIN, EQUILIBRIUM, lambda_mse)
        return (({"fmri": jnp.asarray(fmri), "image": jnp.asarray(image)}, key,
                 *map(jnp.float32, gate)),
                (*map(torch.from_numpy, (fmri, image, eps, z_p)), *gate))

    return _run(jstate, state, jfns.train_step, fns.train_step, feed, cfg, kind)


def test_exp_vae_matches_jax():
    """'vae': the decoder always trains, the discriminator never (its
    parameters and moments bitwise as they were, its BatchNorm ticked three
    times); the decoder unclamped at lambda_mse 1."""
    start, state, history, _ = _scratch_case("vae", 1.0, 0)
    assert all((h["train_dec"], h["train_dis"]) == (1.0, 0.0) for h in history)
    sd = state.nets.state_dict()
    for k, v in sd.items():
        if k.startswith("discriminator.") and "running" not in k and "num_batches" not in k:
            assert torch.equal(v, start[k]), k
        if k.startswith("discriminator.") and "running_mean" in k:
            assert not torch.equal(v, start[k]), k
    assert int(sd["discriminator.fc.1.num_batches_tracked"]) == 3
    assert all(torch.equal(v, torch.ones_like(v))
               for v in state.opt_state["discriminator"].values())


def test_exp_vgan_matches_jax():
    """'vae-gan': all three groups clamped, the equilibrium gate."""
    _, _, history, _ = _scratch_case("vae-gan", 1e-6, 1)
    assert any(h["train_dis"] == 1.0 for h in history)


def _dcgan1_case(seed, score_bias):
    jcfg, cfg = _flags()
    kind = "dcgan"
    groups = convert.random_groups(cfg, seed, kind)
    groups["discriminator"]["params"]["Dense_1"]["bias"] = np.full(
        (1,), score_bias, np.float32)
    opt = JaxRmsProp(jcfg.train.rms_decay, jcfg.train.rms_eps, clip=1.0)
    jstate, state = _states(groups, jcfg, cfg, kind, DcGan,
                            {"decoder": opt, "discriminator": opt})
    jfns = jax_dcgan1_step(jcfg, donate=False)
    fns = steps_exp.make_dcgan_stage1_step(cfg)

    def feed(i):
        x = images(cfg, B, 20 + i)
        key = jax.random.key(200 + i)
        z_p, = _normals(key, 1, cfg.model.latent_dim)
        gate = (MARGIN, EQUILIBRIUM, 1e-6)
        return ((jnp.asarray(x), key, *map(jnp.float32, gate)),
                (torch.from_numpy(x), torch.from_numpy(z_p), *gate))

    return _run(jstate, state, jfns.train_step, fns.train_step, feed, cfg, kind), (fns, cfg)


def test_dcgan_stage1_discriminator_trains():
    """The discriminator trains every step, so loss_dis joins the decoder's
    gradient."""
    (_, _, history, _), _ = _dcgan1_case(2, 0.0)
    assert all((h["train_dec"], h["train_dis"]) == (1.0, 1.0) for h in history)


def test_dcgan_stage1_discriminator_gated_off():
    """D scores about 0.9: the script's means, -log(D(x)) and
    -log(D(x_tilde)), are both about 0.1, below equilibrium - margin, so the
    discriminator stops and the decoder trains on loss_dec alone (the
    family's gate, on -log(1 - D(x_tilde)) = 2.3, would have trained both).
    Its eval step decodes the draws it is given."""
    (_, state, history, _), (fns, cfg) = _dcgan1_case(3, 2.2)
    assert history[0]["train_dec"] == 1.0 and history[0]["train_dis"] == 0.0
    z = np.array(jax.random.normal(jax.random.key(9), (B, cfg.model.latent_dim)))
    x = torch.from_numpy(images(cfg, B, 0))
    got = fns.eval_step(state, x, torch.from_numpy(z))
    assert torch.equal(got, fns.generate_step(state, torch.from_numpy(z)))


def test_dcgan_stage2_matches_jax():
    """The encoder frozen in train mode (parameters bitwise, no moments, its
    BatchNorm ticked); the decoder unclamped, the discriminator clamped."""
    jcfg, cfg = _flags()
    kind = "vae-gan-cognitive"
    groups = convert.random_groups(cfg, 4, kind)
    del groups["teacher_encoder"]
    t = jcfg.train
    jstate, state = _states(groups, jcfg, cfg, kind, CognitiveVaeGan, {
        "decoder": JaxRmsProp(t.rms_decay, t.rms_eps),
        "discriminator": JaxRmsProp(t.rms_decay, t.rms_eps, clip=1.0)})
    jfns = jax_dcgan2_step(jcfg, donate=False)
    fns = steps_exp.make_dcgan_stage2_step(cfg)

    def feed(i):
        fmri, image = _batch(cfg, 30 + i)
        key = jax.random.key(300 + i)
        eps, z_p = _normals(key, 2, cfg.model.latent_dim)
        gate = (MARGIN, EQUILIBRIUM, 1.0)
        return (({"fmri": jnp.asarray(fmri), "image": jnp.asarray(image)}, key,
                 *map(jnp.float32, gate)),
                (*map(torch.from_numpy, (fmri, image, eps, z_p)), *gate))

    start, state, _, _ = _run(jstate, state, jfns.train_step, fns.train_step, feed, cfg,
                              kind, frozen=("encoder.",))
    sd = state.nets.state_dict()
    assert sorted(state.opt_state) == ["decoder", "discriminator"]
    assert not torch.equal(sd["encoder.fc1.1.running_mean"], start["encoder.fc1.1.running_mean"])
    assert int(sd["encoder.fc1.1.num_batches_tracked"]) == 3
    assert int(sd["decoder.fc.1.num_batches_tracked"]) == 6  # x_tilde, then x_p


def test_step_factory_checks():
    _, cfg = _flags()
    with pytest.raises(ValueError, match="mode must be one of"):
        steps_exp.make_cognitive_scratch_step(cfg, "dcgan")
