"""The port at ``res100``, the paper's preset, against the JAX package on the
CPU: 100 px images, latent 512, a 13x13 bottleneck, decoder output padding
(False, True, True), and a discriminator whose first conv has stride 2
(``stride_gan=2``: 100 -> 50 -> 25 -> 13 -> 7) with a 7x7x256 -> 256 FC.
No other tested preset has that structure. The helpers are
``tests/test_torch_train.py``'s.

  * the converter at res100: its CHW <-> HWC permutes of the FCs at 13x13
    (encoder, decoder) and 7x7 (discriminator) equal the JAX export key for
    key, and the state loads strictly;
  * the three stage-I nets, in train mode (outputs and BatchNorm running
    statistics) and eval mode: the encoder's mu and logvar, the decoder's
    image, the discriminator's pre-BN feature tap and score (rtol 1e-4,
    atol 1e-5);
  * the stage-I step, flags off, batch 4, after one step and after three,
    under the bounds of ``CASES`` (below).
"""

import pytest
import test_torch_train as T

from fmri_tpu_torch.configs import get_config

# (preset, kernel flags, compute dtype, batch, bounds after step 1, after
# step 3), as test_torch_train.CASES. Each bound is about twice the gap that
# tests/torch_step_drift.py measures on the CPU: losses 4.1e-7 / 5.1e-4,
# parameter movement 1.4e-2 / 0.18, BN statistics 2.0e-6 / 2.2e-2, RMSprop
# moments 5.1e-3 / 0.28. As at res64 with batch 4 (gaps 4.5e-7 / 1.0e-4,
# 8.6e-3 / 0.10, 2.4e-6 / 7.4e-3, 5.2e-3 / 8.8e-2 in the same run), the step
# is ill-conditioned: BatchNorm over 4 images, and at latent 512 the KL terms
# are larger still, so three steps carry the first step's rounding further.
CASES = {
    "res100-fp32": ("res100", False, None, 4,
                    dict(loss=1e-6, param=3e-2, stats=4e-6, sq=1e-2),
                    dict(loss=1e-3, param=0.4, stats=4e-2, sq=0.6)),
}


def test_res100_has_the_structure_no_other_preset_has():
    c = get_config("res100").model
    assert (c.image_size, c.latent_dim, c.fc_input, c.stride_gan, c.fc_input_gan,
            c.fc_output_gan, tuple(c.output_pad_dec)) == (
                100, 512, 13, 2, 7, 256, (False, True, True))


def test_state_dict_loads_strict_and_equals_export():
    T.test_state_dict_loads_strict_and_equals_export("res100")


@pytest.mark.parametrize("train", [True, False])
def test_forwards_and_batch_stats_match_jax(train):
    T.test_forwards_and_batch_stats_match_jax("res100", False, train)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(case):
    T.step_matches_jax(CASES[case])
