"""Train state of the VAE/GAN family: the named groups, their RMSprop
moments and the step count.

Counterpart of ``fmri_tpu/train/state.py:29-90``. The JAX state is one
pytree of groups; here each group is a submodule (parameters and BatchNorm
running statistics) of

* :class:`VaeGan`, stage I: the reference's ``VaeGan`` state dict
  (``vae_gan.py:235-320``, keys ``encoder.*``, ``decoder.*``,
  ``discriminator.*``);
* :class:`VaeGanCognitiveTrain`, stages II and III: the reference's stage-2
  ``VaeGanCognitive`` (``vae_gan.py:323-432``), ``encoder.*`` (cognitive),
  ``decoder.*``, ``discriminator.*`` and ``teacher_net.*``, the stage-I
  teacher whose decoder and discriminator are the same module objects
  (``train_vgan_stage2.py:229-232``), so torch lists them under both
  prefixes.

Either loads a reference state dict with ``strict=True``. Frozen groups
are groups without an optimizer. The train step updates the modules and
moments in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
from torch import nn

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.models.nets import (
    CognitiveEncoder, Decoder, ImageDiscriminator, VisualEncoder,
)
from fmri_tpu_torch.train.optim import Moments, RmsProp

GROUPS = ("encoder", "decoder", "discriminator")
# the groups each cognitive stage trains (fmri_tpu/train/stages.py:87,106)
COGNITIVE_TRAINED = {2: ("encoder", "discriminator"), 3: ("decoder", "discriminator")}


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


class VaeGanCognitiveTrain(nn.Module):
    """The stage-II/III model: ``encoder`` (CognitiveEncoder), ``decoder``,
    ``discriminator`` and ``teacher_net``: a stage-I :class:`VaeGan` whose
    ``decoder`` and ``discriminator`` are this module's own. Group
    ``"teacher_encoder"`` is ``teacher_net.encoder``, the JAX group name."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.encoder = CognitiveEncoder(cfg.model)
        self.decoder = Decoder(cfg.model)
        self.discriminator = ImageDiscriminator(cfg.model)
        self.teacher_net = VaeGan(cfg)
        self.teacher_net.decoder = self.decoder
        self.teacher_net.discriminator = self.discriminator

    def group(self, name: str) -> Dict[str, nn.Parameter]:
        """The named parameters of one group."""
        module = self.teacher_net.encoder if name == "teacher_encoder" else getattr(self, name)
        return dict(module.named_parameters())


@dataclasses.dataclass
class TrainState:
    nets: nn.Module                # VaeGan or VaeGanCognitiveTrain
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


def init_cognitive(cfg: Config, stage1: VaeGan | None = None,
                   seed: int = 0) -> VaeGanCognitiveTrain:
    """A stage-II model on the CPU: a fresh CognitiveEncoder from ``seed``
    (``fmri_tpu/train/state.py:58-63``); the decoder, the discriminator and
    the teacher's encoder copied from the stage-I triplet ``stage1`` when
    given (``fmri_tpu/train/stages.py:79-85``), else drawn from ``seed``
    too."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = init_parameters(VaeGanCognitiveTrain(cfg))
    if stage1 is not None:
        for name in ("decoder", "discriminator", "encoder"):
            target = nets.teacher_net.encoder if name == "encoder" else getattr(nets, name)
            target.load_state_dict(getattr(stage1, name).state_dict(), strict=True)
    return nets


def make_state(nets: VaeGan | VaeGanCognitiveTrain, optimizers: Mapping[str, object],
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


def make_cognitive_state(nets: VaeGanCognitiveTrain, cfg: Config, stage: int,
                         moments: Mapping[str, Moments] | None = None) -> TrainState:
    """The TrainState of stage 2 or 3: RMSprop moments for the groups the
    stage trains (:data:`COGNITIVE_TRAINED`), the others frozen."""
    t = cfg.train
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    return make_state(nets, {g: opt for g in COGNITIVE_TRAINED[stage]}, moments)
