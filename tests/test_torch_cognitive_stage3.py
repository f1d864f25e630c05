"""The port's stage-III cognitive step, and both cognitive stages with the
fused decoder batch, against the JAX package's ``make_vgan_cognitive_step``
on the CPU at ``tiny``. The helpers, inputs and tolerances are
``tests/test_torch_cognitive.py``'s; the stage-III cases sit in a file of
their own so that the JAX compiles of the two stages run on two workers."""

import jax
import numpy as np
import pytest
import torch
from test_torch_cognitive import (
    EQUILIBRIUM, KIND, LAMBDA_MSE, MARGIN, _batch, _check_case, _configs, _noise,
    _port_state, _run_both,
)

from fmri_tpu_torch.checkpoints import convert
from fmri_tpu_torch.train.steps_vgan import MODES, make_vgan_cognitive_step


@pytest.mark.parametrize("flags", [False, True], ids=["flags-off", "kernels"])
@pytest.mark.parametrize("mode", MODES)
def test_stage3_step_matches_jax(mode, flags):
    """Stage III against the JAX step (``_check_case``): the decoder and
    the discriminator under the equilibrium gate, the cognitive encoder
    frozen but ticking its BatchNorm statistics."""
    _check_case(3, mode, False, flags)


@pytest.mark.parametrize("stage", [2, 3])
@pytest.mark.parametrize("pallas_backward", [False, True])
def test_fused_decoder_batch(stage, pallas_backward):
    """``fused_decoder_batch`` (stage II: the grad-free [z_t, z_p] decode;
    stage III: [z, z_p]) gives the unfused step's update in the port (atol
    1e-6 on parameters and statistics: E[x^2] - mean^2 against torch's
    two-pass variance) and the JAX fused step's, with ``pallas_bn`` off
    (vsplit forbids it) and ``pallas_backward`` on and off."""
    jcfg, cfg = _configs(pallas_backward=pallas_backward, fused=True)
    state, _ = _run_both(jcfg, cfg, stage, "vae-gan", True)
    _, cfg_seq = _configs(pallas_backward=pallas_backward)
    seq = _port_state(convert.random_groups(cfg, 0, KIND), cfg_seq, stage)
    step = make_vgan_cognitive_step(cfg_seq, stage)
    for i in range(3):
        fmri, image = _batch(cfg, 8, 10 + i)
        noise = _noise(jax.random.key(100 + i), 8, 16)
        seq, _ = step.train_step(seq, *map(torch.from_numpy, (fmri, image, *noise)),
                                 MARGIN, EQUILIBRIUM, LAMBDA_MSE)
    ref = seq.nets.state_dict()
    for k, v in state.nets.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
