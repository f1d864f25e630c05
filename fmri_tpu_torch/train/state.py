"""Train state of the VAE/GAN and WAE families: the named groups, their
optimizer moments (RMSprop or Adam) and the step count.

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
  prefixes;
* :class:`WaeGan`, WAE stage I: the reference's ``WaeGan``
  (``vae_gan.py:435-496``), ``encoder.*`` (visual), ``decoder.*`` and the
  latent discriminator (group ``latent_disc``) under the reference's
  ``discriminator.*``;
* :class:`WaeGanCognitiveTrain`, WAE stages II and III: the reference's
  ``WaeGanCognitive`` (``vae_gan.py:532-578``; ``encoder.*`` cognitive,
  ``decoder.*``, ``discriminator.*`` the latent discriminator) and the
  frozen stage-I encoder, ``teacher_encoder.*``;
* :class:`WaeDualGan`, WAE/Dual-GAN: the stage-I triplet's keys and the
  latent discriminator under ``latent_disc.*``.

Each loads a reference state dict with ``strict=True`` (the WAE
cognitive module with the teacher added). Frozen groups are groups without
an optimizer. The train step updates the modules and moments in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
from torch import nn

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.models.nets import (
    CognitiveEncoder, Decoder, ImageDiscriminator, LatentDiscriminator, VisualEncoder,
)
from fmri_tpu_torch.train.optim import Adam, AdamState, Moments, RmsProp

GROUPS = ("encoder", "decoder", "discriminator")
# the groups each cognitive stage trains (fmri_tpu/train/stages.py:87,106)
COGNITIVE_TRAINED = {2: ("encoder", "discriminator"), 3: ("decoder", "discriminator")}
WAE_GROUPS = ("encoder", "decoder", "latent_disc")
WAE_DUAL_GROUPS = GROUPS + ("latent_disc",)
# the groups each WAE cognitive stage trains (fmri_tpu/train/stages.py:146,180)
WAE_COGNITIVE_TRAINED = {2: ("encoder", "latent_disc"), 3: ("decoder", "latent_disc")}


class _Groups(nn.Module):
    """A train module of named groups: ``PREFIXES`` maps each group to the
    state-dict prefix of its submodule (by default the group's own name);
    ``module(name)`` is that submodule and ``group(name)`` its named
    parameters. The checkpoint store saves and grafts groups by these
    names."""

    PREFIXES: Dict[str, str] = {}

    def module(self, name: str) -> nn.Module:
        if name not in self.PREFIXES:
            raise KeyError(f"{type(self).__name__} has no group {name!r}; "
                           f"its groups: {sorted(self.PREFIXES)}")
        return self.get_submodule(self.PREFIXES[name][:-1])

    def group(self, name: str) -> Dict[str, nn.Parameter]:
        return dict(self.module(name).named_parameters())


class VaeGan(_Groups):
    """The stage-I triplet: ``encoder`` (VisualEncoder), ``decoder``,
    ``discriminator`` (ImageDiscriminator)."""

    PREFIXES = {g: g + "." for g in GROUPS}

    def __init__(self, cfg: Config):
        super().__init__()
        self.encoder = VisualEncoder(cfg.model)
        self.decoder = Decoder(cfg.model)
        self.discriminator = ImageDiscriminator(cfg.model)


class VaeGanCognitiveTrain(_Groups):
    """The stage-II/III model: ``encoder`` (CognitiveEncoder), ``decoder``,
    ``discriminator`` and ``teacher_net``: a stage-I :class:`VaeGan` whose
    ``decoder`` and ``discriminator`` are this module's own. Group
    ``"teacher_encoder"`` is ``teacher_net.encoder``, the JAX group name."""

    PREFIXES = {**VaeGan.PREFIXES, "teacher_encoder": "teacher_net.encoder."}

    def __init__(self, cfg: Config):
        super().__init__()
        self.encoder = CognitiveEncoder(cfg.model)
        self.decoder = Decoder(cfg.model)
        self.discriminator = ImageDiscriminator(cfg.model)
        self.teacher_net = VaeGan(cfg)
        self.teacher_net.decoder = self.decoder
        self.teacher_net.discriminator = self.discriminator


class WaeGan(_Groups):
    """WAE stage I: ``encoder`` (VisualEncoder), ``decoder`` and
    ``discriminator``, the LatentDiscriminator of group ``latent_disc``."""

    PREFIXES = {"encoder": "encoder.", "decoder": "decoder.",
                "latent_disc": "discriminator."}

    def __init__(self, cfg: Config):
        super().__init__()
        self.encoder = VisualEncoder(cfg.model)
        self.decoder = Decoder(cfg.model)
        self.discriminator = LatentDiscriminator(cfg.model)


class WaeGanCognitiveTrain(_Groups):
    """WAE stages II and III: ``encoder`` (CognitiveEncoder), ``decoder``,
    ``discriminator`` (the LatentDiscriminator, group ``latent_disc``) and
    ``teacher_encoder``, the frozen stage-I VisualEncoder."""

    PREFIXES = {**WaeGan.PREFIXES, "teacher_encoder": "teacher_encoder."}

    def __init__(self, cfg: Config):
        super().__init__()
        self.encoder = CognitiveEncoder(cfg.model)
        self.decoder = Decoder(cfg.model)
        self.discriminator = LatentDiscriminator(cfg.model)
        self.teacher_encoder = VisualEncoder(cfg.model)


class WaeDualGan(_Groups):
    """WAE/Dual-GAN: the stage-I triplet ``encoder``, ``decoder``,
    ``discriminator`` (ImageDiscriminator) and ``latent_disc``."""

    PREFIXES = {g: g + "." for g in WAE_DUAL_GROUPS}

    def __init__(self, cfg: Config):
        super().__init__()
        self.encoder = VisualEncoder(cfg.model)
        self.decoder = Decoder(cfg.model)
        self.discriminator = ImageDiscriminator(cfg.model)
        self.latent_disc = LatentDiscriminator(cfg.model)


OptState = Dict[str, Moments | AdamState]


@dataclasses.dataclass
class TrainState:
    nets: nn.Module       # VaeGan, VaeGanCognitiveTrain, WaeGan, ...
    opt_state: OptState   # {group: {parameter name: sq_avg}, or AdamState}
    step: torch.Tensor    # int64 scalar on the device: applied steps


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


def init_wae(cfg: Config, seed: int = 0) -> WaeGan:
    """A fresh WAE stage-I model on the CPU from ``seed``: the reference init,
    the latent discriminator's the ``WaeGan`` re-init ("uniform",
    ``fmri_tpu/train/stages.py:123``)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = init_parameters(WaeGan(cfg))
        nets.discriminator.init_weights("uniform")
    return nets


def init_wae_cognitive(cfg: Config, stage1: WaeGan | None = None,
                       seed: int = 0) -> WaeGanCognitiveTrain:
    """A WAE stage-II model on the CPU: a fresh CognitiveEncoder and latent
    discriminator ("normal", the ctor init) from ``seed``; the decoder and
    the teacher encoder copied from the stage-I ``stage1`` when given
    (``fmri_tpu/train/stages.py:145-150``), else drawn from ``seed`` too."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = init_parameters(WaeGanCognitiveTrain(cfg))
        nets.discriminator.init_weights("normal")
    if stage1 is not None:
        nets.decoder.load_state_dict(stage1.decoder.state_dict(), strict=True)
        nets.teacher_encoder.load_state_dict(stage1.encoder.state_dict(), strict=True)
    return nets


def init_wae_dual_gan(cfg: Config, seed: int = 0) -> WaeDualGan:
    """A fresh WAE/Dual-GAN model on the CPU from ``seed``; the latent
    discriminator takes the "uniform" init (``fmri_tpu/train/stages.py:197``)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = init_parameters(WaeDualGan(cfg))
        nets.latent_disc.init_weights("uniform")
    return nets


def _moments_on(moments, params, device):
    if isinstance(moments, AdamState):
        return AdamState(_moments_on(moments.mu, params, device),
                         _moments_on(moments.nu, params, device),
                         moments.count.to(device, torch.int32).clone())
    return {k: moments[k].to(device).clone() for k in params}


def make_state(nets: nn.Module, optimizers: Mapping[str, object],
               moments: Mapping[str, Moments | AdamState] | None = None) -> TrainState:
    """A TrainState over ``nets`` with one optimizer per trained group
    (``{"encoder": RmsProp(), ...}``). ``moments`` gives starting moments
    (e.g. from :func:`fmri_tpu_torch.checkpoints.convert.moments_from_jax`:
    ``sq_avg`` per parameter, or an ``AdamState``); otherwise each
    optimizer's ``init``."""
    device = next(nets.parameters()).device
    opt_state = {}
    for name, opt in optimizers.items():
        params = nets.group(name)
        opt_state[name] = (opt.init(params) if moments is None
                           else _moments_on(moments[name], params, device))
    return TrainState(nets, opt_state, torch.zeros((), dtype=torch.int64, device=device))


def make_cognitive_state(nets: VaeGanCognitiveTrain, cfg: Config, stage: int,
                         moments: Mapping[str, Moments] | None = None) -> TrainState:
    """The TrainState of stage 2 or 3: RMSprop moments for the groups the
    stage trains (:data:`COGNITIVE_TRAINED`), the others frozen."""
    t = cfg.train
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    return make_state(nets, {g: opt for g in COGNITIVE_TRAINED[stage]}, moments)


def make_wae_state(nets: WaeGan, cfg: Config,
                   moments: Mapping[str, AdamState] | None = None) -> TrainState:
    """WAE stage I: Adam(``adam_b1``, ``adam_b2``) for every group
    (``fmri_tpu/train/stages.py:124-125``)."""
    opt = Adam(b1=cfg.train.adam_b1, b2=cfg.train.adam_b2)
    return make_state(nets, {g: opt for g in WAE_GROUPS}, moments)


def make_wae_cognitive_state(nets: WaeGanCognitiveTrain, cfg: Config, stage: int,
                             moments: Mapping[str, AdamState] | None = None
                             ) -> TrainState:
    """WAE stage 2 or 3: Adam(0.5, 0.999) for the groups the stage trains
    (:data:`WAE_COGNITIVE_TRAINED`), the others frozen."""
    opt = Adam(b1=0.5, b2=0.999)
    return make_state(nets, {g: opt for g in WAE_COGNITIVE_TRAINED[stage]}, moments)


def make_wae_dual_gan_state(nets: WaeDualGan, cfg: Config,
                            moments: Mapping[str, Moments] | None = None) -> TrainState:
    """WAE/Dual-GAN: RMSprop for all four groups
    (``fmri_tpu/train/stages.py:198-199``)."""
    t = cfg.train
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=t.grad_clip)
    return make_state(nets, {g: opt for g in WAE_DUAL_GROUPS}, moments)
