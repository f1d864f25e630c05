"""The port's cognitive WAE steps, stages II and III
(``fmri_tpu_torch/train/steps_wae.py::make_wae_cognitive_step``), against the
JAX package's ``make_wae_cognitive_step`` on the CPU at ``tiny``.

Both packages start from the same seeded ``"wae-gan-cognitive"`` groups
(cognitive encoder, decoder, latent discriminator and the frozen stage-I
teacher encoder) and the same fMRI and images; the step draws no noise.
Adam starts from mu 0, nu 1, count 0 on both sides, and the tolerances are
those of ``tests/test_torch_wae.py`` (``TOL``: losses 1e-6 relative,
parameter movement 1e-3, BN statistics 1e-5, Adam first moments 1e-3 and
second moments 1e-5, counts exact), after step 1 and after step 3; the
frozen groups' parameters are held bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wae import (
    compare, configs, count_kernel_calls, jax_state, port_moments, ticks,
)

from fmri_tpu.train import Adam as JaxAdam
from fmri_tpu.train import make_wae_cognitive_step as jax_step
from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.train.optim import step_lr
from fmri_tpu_torch.train.state import (
    WAE_COGNITIVE_TRAINED, WaeGanCognitiveTrain, make_wae_cognitive_state,
)
from fmri_tpu_torch.train.steps_wae import make_wae_cognitive_step

KIND = "wae-gan-cognitive"
# the state-dict prefixes of the groups each stage freezes
FROZEN = {2: ("decoder.", "teacher_encoder."), 3: ("encoder.", "teacher_encoder.")}


def _states(groups, jcfg, cfg, stage):
    trained = WAE_COGNITIVE_TRAINED[stage]
    jstate = jax_state(groups, trained, lambda g: JaxAdam(0.5, 0.999))
    nets = WaeGanCognitiveTrain(cfg)
    nets.load_state_dict(convert.from_jax_groups(groups, cfg, KIND), strict=True)
    return jstate, make_wae_cognitive_state(nets, cfg, stage,
                                            port_moments(groups, trained, cfg, KIND))


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    s = cfg.model.image_size
    return (rng.normal(size=(b, cfg.model.num_voxels)).astype(np.float32),
            rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32))


@pytest.mark.parametrize("flags", [False, True], ids=["flags-off", "kernels"])
@pytest.mark.parametrize("stage", [2, 3])
def test_cognitive_step_matches_jax(stage, flags):
    """Stage II trains the cognitive encoder on mean recon + mean penalty,
    stage III the decoder on the recon alone, both after the latent D; the
    teacher ticks its BatchNorms once per step, the cognitive encoder twice
    (the reference's phase-2 recompute), the decoder twice in stage II (the
    teacher's gt decode, then x_recon) and once in stage III. The JAX step
    runs with its kernel flags off."""
    jcfg, cfg = configs()
    _, cfg_port = configs(flags, flags)
    groups = convert.random_groups(cfg, 0, KIND)
    jstate, state = _states(groups, jcfg, cfg_port, stage)
    jfns, fns = jax_step(jcfg, stage, donate=False), make_wae_cognitive_step(cfg_port, stage)
    start = {k: v.clone() for k, v in state.nets.state_dict().items()}
    for i in range(3):
        fmri, image = _batch(cfg, 8, 10 + i)
        jstate, jm = jfns.train_step(
            jstate, {"fmri": jnp.asarray(fmri), "image": jnp.asarray(image)}, None)
        state, m = fns.train_step(state, torch.from_numpy(fmri), torch.from_numpy(image))
        if i in (0, 2):
            compare(jstate, jm, state, m, cfg, KIND, start, FROZEN[stage])
    assert ticks(state, "teacher_encoder.") == {3}
    assert ticks(state, "encoder.") == {6}
    assert ticks(state, "decoder.") == {6 if stage == 2 else 3}


@pytest.mark.parametrize("stage,want", [(2, (3, 3, 0)), (3, (3, 3, 4))])
def test_kernel_calls_per_step(monkeypatch, stage, want):
    """Calls of the BN-backward and weight-grad wrappers per step with both
    kernel flags on (on the card, one launch each): one decoder backward,
    to mu in stage II (3 BN, no weight grad: the decoder is frozen) and to
    the decoder's weights in stage III (3 BN, 4 weight grads); the
    cognitive encoder has no conv."""
    counts = count_kernel_calls(monkeypatch)
    jcfg, cfg = configs(True, True)
    _, state = _states(convert.random_groups(cfg, 0, KIND), jcfg, cfg, stage)
    counts.reset()
    make_wae_cognitive_step(cfg, stage).train_step(
        state, *map(torch.from_numpy, _batch(cfg, 4, 0)))
    assert counts.read() == want


def test_schedules_and_checks():
    """The lr schedules reach the updates: a ``step_lr`` schedule at zero
    leaves the decoder as it was (its Adam count still ticks, as torch's
    step with lr 0 does), the default moves it; stages other than 2 and 3
    raise. The default lrs themselves are held against the JAX step above."""
    _, cfg = configs()
    groups = convert.random_groups(cfg, 1, KIND)
    batch = [torch.from_numpy(a) for a in _batch(cfg, 4, 1)]
    for sched, still in ((step_lr(1e-3, 1, 0.0, 1), True), (None, False)):
        _, state = _states(groups, configs()[0], cfg, 3)
        state.step.fill_(1)  # epoch 1: StepLR(1, gamma 0) gives lr 0
        start = {k: v.clone() for k, v in state.nets.decoder.state_dict().items()}
        make_wae_cognitive_step(cfg, 3, lr_schedule_dec=sched).train_step(state, *batch)
        sd = state.nets.decoder.state_dict()
        assert all(torch.equal(sd[k], v) == still for k, v in start.items()
                   if "weight" in k and "bn" not in k), still
        assert int(state.opt_state["decoder"].count) == 1
    for stage in (1, 4):
        with pytest.raises(ValueError, match="stage must be 2 or 3"):
            make_wae_cognitive_step(cfg, stage)
