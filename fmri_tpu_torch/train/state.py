"""Train state of the stage-I VAE/GAN: the three named groups, their
RMSprop moments and the step count.

Counterpart of ``fmri_tpu/train/state.py:29-90``. The JAX state is one
pytree of groups; here each group is a submodule of :class:`VaeGan`
(parameters and BatchNorm running statistics), so the reference's
``VaeGan`` state dict (``vae_gan.py:235-320``, keys ``encoder.*``,
``decoder.*``, ``discriminator.*``) loads with ``strict=True``. The train
step updates the modules and moments in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
from torch import nn

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.models.nets import Decoder, ImageDiscriminator, VisualEncoder
from fmri_tpu_torch.train.optim import Moments

GROUPS = ("encoder", "decoder", "discriminator")


class VaeGan(nn.Module):
    """The stage-I triplet: ``encoder`` (VisualEncoder), ``decoder``,
    ``discriminator`` (ImageDiscriminator)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.encoder = VisualEncoder(cfg.model)
        self.decoder = Decoder(cfg.model)
        self.discriminator = ImageDiscriminator(cfg.model)

    def group(self, name: str) -> Dict[str, nn.Parameter]:
        """The named parameters of one group."""
        return dict(getattr(self, name).named_parameters())


@dataclasses.dataclass
class TrainState:
    nets: VaeGan
    opt_state: Dict[str, Moments]  # {group: {parameter name: sq_avg}}
    step: torch.Tensor             # int64 scalar on the device: applied steps


@torch.no_grad()
def init_parameters(module: nn.Module) -> nn.Module:
    """The reference init (``vae_gan.py:252-264``, as the JAX package draws
    it, ``nets.py:38-40``): every conv, deconv and linear weight
    U(-a, a) with a = 1/sqrt(3 * fan_in), fan_in counted over the input
    channels and taps; biases 0; BatchNorm scale 1, shift 0, running 0/1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, (nn.Conv2d, nn.Linear)) \
                else w.shape[0] * w[0, 0].numel()
            w.uniform_(-(3.0 * fan_in) ** -0.5, (3.0 * fan_in) ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module


def init_vaegan(cfg: Config, seed: int = 0) -> VaeGan:
    """A freshly initialised stage-I triplet on the CPU, from ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return init_parameters(VaeGan(cfg))


def make_state(nets: VaeGan, optimizers: Mapping[str, object],
               moments: Mapping[str, Moments] | None = None) -> TrainState:
    """A TrainState over ``nets`` with one optimizer per trained group
    (``{"encoder": RmsProp(), ...}``). ``moments`` gives starting moments
    (e.g. from :func:`fmri_tpu_torch.checkpoints.convert.moments_from_jax`);
    otherwise each optimizer's ``init``."""
    device = next(nets.parameters()).device
    opt_state = {}
    for name, opt in optimizers.items():
        params = nets.group(name)
        if moments is None:
            opt_state[name] = opt.init(params)
        else:
            opt_state[name] = {k: moments[name][k].to(device).clone() for k in params}
    return TrainState(nets, opt_state, torch.zeros((), dtype=torch.int64, device=device))
