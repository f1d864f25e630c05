"""Stage builders: (TrainState, StepFns, Trainer keywords) per stage.

Counterpart of ``fmri_tpu/train/stages.py:52-313``, one builder per
reference trainer script:

  * ``vgan_stage1`` ``train_vgan_stage1.py`` (Dual-VAE/GAN on images)
  * ``vgan_stage2`` ``train_vgan_stage2.py`` (cognitive, distillation)
  * ``vgan_stage3`` ``train_vgan_stage3.py`` (decoder fine-tune)
  * ``wae_stage1`` ``train_wae_stage1.py`` (WAE/GAN on images)
  * ``wae_stage2`` ``train_wae_stage2.py`` (cognitive latent alignment)
  * ``wae_stage3`` ``train_wae_stage3.py`` (decoder recon fine-tune)
  * ``wae_vgan_stage1`` ``wae_vgan_stage1.py`` (WAE/Dual-GAN)
  * ``exp_decoder`` ``experiments/exp_decoder.py`` (supervised decoder)
  * ``exp_vae``, ``exp_vgan`` ``experiments/exp_vae.py``, ``exp_vgan.py``
    (cognitive VAE, VAE/GAN from scratch)
  * ``exp_dcgan_stage1``, ``exp_dcgan_stage2``
    ``experiments/exp_dcgan_stage{1,2}.py`` (DCGAN, cognitive over it)

Each builds its train module on ``device`` from ``seed`` (the port's own
reference init, ``train/state.py``), the same trained groups, optimizers
and per-epoch lr schedules as its JAX twin, and an adapter that gives the
trainer one signature for every family: ``train_step(state, batch, noise,
*gate)``, ``eval_step(state, input, eps)`` and ``generate_step(state,
z_p)``. Its keywords name the noise the step takes, in the JAX step's split
order, and the augmentation.

Later stages read the previous stage's port checkpoint dir (``epoch``,
default the latest) or a reference-layout ``.pth`` and graft groups as the
JAX builders do: the stage-II teacher from the stage-I encoder, stage III
from stage II, the WAE stage-III teacher from stage I, a fresh latent
discriminator in WAE stages II and III, the DCGAN stage-2 decoder and
discriminator from DCGAN stage 1.

``mesh``: the step of a multi-rank run (``parallel/mesh.py``); the
``Trainer`` of the same mesh places the state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from fmri_tpu_torch.checkpoints.store import graft_groups, load_groups
from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.device import resolve_device
from fmri_tpu_torch.train.optim import Adam, RmsProp, exponential_lr, step_lr
from fmri_tpu_torch.train.state import (
    GROUPS, WAE_DUAL_GROUPS, WAE_GROUPS, CognitiveVaeGan, DcGan, TrainState, VaeGan,
    VaeGanCognitiveTrain, WaeGan, WaeGanCognitiveTrain, init_cognitive, init_groups,
    init_vaegan, init_voxel_decoder, init_wae, init_wae_cognitive, init_wae_dual_gan,
    make_state,
)
from fmri_tpu_torch.train.steps_exp import (
    make_cognitive_scratch_step, make_dcgan_stage1_step, make_dcgan_stage2_step,
    make_supervised_decoder_step,
)
from fmri_tpu_torch.train.steps_vgan import (
    StepFns, make_vgan_cognitive_step, make_vgan_stage1_step,
)
from fmri_tpu_torch.train.steps_wae import (
    make_wae_cognitive_step, make_wae_stage1_step, make_wae_vgan_step,
)

Built = Tuple[TrainState, StepFns, Dict[str, Any]]

# the noise each step takes, in the JAX step's split order
# (fmri_tpu/train/steps_vgan.py:236-238, :545-548; steps_wae.py:63, :492-495)
VGAN_STAGE1_NOISE = (("eps", 1.0), ("z_p", 1.0))
VGAN_COGNITIVE_NOISE = (("eps", 1.0), ("eps_t", 1.0), ("z_p", 1.0))
EXP_NOISE = VGAN_STAGE1_NOISE  # the cognitive ablations (steps_exp.py:110-112, :314-316)


def _image_kwargs(uses_gate: bool, eval_sample: bool, noise) -> Dict[str, Any]:
    return dict(data_kind="image", uses_gate=uses_gate, eval_sample=eval_sample,
                noise=noise, augment=dict(flip=True, max_shift=0))


def _pair_kwargs(cfg: Config, uses_gate: bool, eval_sample: bool, noise) -> Dict[str, Any]:
    return dict(data_kind="pair", uses_gate=uses_gate, eval_sample=eval_sample,
                noise=noise, augment=dict(flip=False, max_shift=cfg.data.max_shift))


def _pair_eval(step: StepFns):
    return lambda state, batch, eps: step.eval_step(state, batch["fmri"], eps)


# --------------------------- Dual-VAE/GAN family ---------------------------


def vgan_stage1(cfg: Config, *, mode: str = "vae-gan", steps_per_epoch: int,
                seed: int = 8, device: str = "cuda",
                mesh=None) -> Built:
    """Stage-I VAE/GAN: a fresh triplet, RMSprop for each group, per-epoch
    ExponentialLR (``train_vgan_stage1.py:237,275-283``)."""
    t = cfg.train
    step = make_vgan_stage1_step(cfg, mode, lr_schedule=exponential_lr(
        t.learning_rate, t.decay_lr, steps_per_epoch), mesh=mesh)
    nets = init_vaegan(cfg, seed).to(resolve_device(device))
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=t.grad_clip)
    state = make_state(nets, {g: opt for g in GROUPS})
    steps = StepFns(lambda s, x, noise, *gate: step.train_step(
        s, x, noise["eps"], noise["z_p"], *gate), step.eval_step, step.generate_step)
    return state, steps, _image_kwargs(True, True, VGAN_STAGE1_NOISE)


def _cognitive_steps(step: StepFns) -> StepFns:
    return StepFns(lambda s, batch, noise, *gate: step.train_step(
        s, batch["fmri"], batch["image"], noise["eps"], noise["eps_t"], noise["z_p"],
        *gate), _pair_eval(step), step.generate_step)


def vgan_stage2(cfg: Config, stage1_ckpt: str, *, mode: str = "vae-gan",
                use_teacher: bool = True, steps_per_epoch: int, seed: int = 8,
                epoch: Optional[int] = None, device: str = "cuda",
                mesh=None) -> Built:
    """Stage-II cognitive: a fresh CognitiveEncoder; the decoder, the
    discriminator and the teacher encoder from the stage-I checkpoint;
    decoder and teacher frozen; gradients clamped to +-1
    (``train_vgan_stage2.py:213-232,328-329``). Without ``use_teacher``
    (``--mode vae`` path, ``:234-238``) the teacher is loaded but unused."""
    t = cfg.train
    step = make_vgan_cognitive_step(cfg, 2, mode, use_teacher=use_teacher,
                                    lr_schedule=exponential_lr(
                                        t.learning_rate, t.decay_lr, steps_per_epoch),
                                    mesh=mesh)
    nets = init_cognitive(cfg, seed=seed)
    loaded = load_groups(stage1_ckpt, ["encoder", "decoder", "discriminator"], epoch,
                         prefixes=VaeGan.PREFIXES)
    graft_groups(nets, loaded, {"decoder": "decoder", "discriminator": "discriminator",
                                "teacher_encoder": "encoder"})
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    state = make_state(nets.to(resolve_device(device)),
                       {"encoder": opt, "discriminator": opt})
    return state, _cognitive_steps(step), _pair_kwargs(cfg, True, True, VGAN_COGNITIVE_NOISE)


def vgan_stage3(cfg: Config, stage2_ckpt: str, *, mode: str = "vae-gan",
                steps_per_epoch: int, seed: int = 8, epoch: Optional[int] = None,
                device: str = "cuda", mesh=None) -> Built:
    """Stage III: the whole stage-II module reloaded; the cognitive encoder
    frozen; decoder and discriminator trained under the equilibrium gate
    (``train_vgan_stage3.py:241-245,329-334,382-388``). ``seed`` is unused,
    as in the JAX builder: nothing is drawn."""
    t = cfg.train
    step = make_vgan_cognitive_step(cfg, 3, mode, use_teacher=False,
                                    lr_schedule=exponential_lr(
                                        t.learning_rate, t.decay_lr, steps_per_epoch),
                                    mesh=mesh)
    names = ["encoder", "decoder", "discriminator", "teacher_encoder"]
    nets = graft_groups(VaeGanCognitiveTrain(cfg), load_groups(
        stage2_ckpt, names, epoch, prefixes=VaeGanCognitiveTrain.PREFIXES),
        {n: n for n in names})
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    state = make_state(nets.to(resolve_device(device)),
                       {"decoder": opt, "discriminator": opt})
    return state, _cognitive_steps(step), _pair_kwargs(cfg, True, True, VGAN_COGNITIVE_NOISE)


# --------------------------- WAE/GAN family ---------------------------


def wae_stage1(cfg: Config, *, steps_per_epoch: int, seed: int = 8,
               device: str = "cuda", mesh=None) -> Built:
    """Stage-I WAE/GAN: fresh encoder, decoder and latent D, Adam(b1, b2)
    with the D at 0.5x lr, StepLR(30, 0.5) (``train_wae_stage1.py:221-228``).
    The step's noise is z_fake ~ N(0, wae_sigma^2), drawn from the step's
    key unsplit."""
    t = cfg.train
    step = make_wae_stage1_step(cfg, lr_schedule=step_lr(
        t.learning_rate, t.step_size, t.step_gamma, steps_per_epoch), mesh=mesh)
    nets = init_wae(cfg, seed).to(resolve_device(device))
    opt = Adam(b1=t.adam_b1, b2=t.adam_b2)
    state = make_state(nets, {g: opt for g in WAE_GROUPS})
    steps = StepFns(lambda s, x, noise: step.train_step(s, x, noise["z_fake"]),
                    step.eval_step, step.generate_step)
    return state, steps, _image_kwargs(False, False, (("z_fake", t.wae_sigma),))


def _wae_cognitive_step(cfg: Config, stage: int, steps_per_epoch: int,
                        mesh=None) -> StepFns:
    """The stage-II/III step with the reference's hard-coded lrs, 1e-3
    (encoder, decoder) and 5e-4 (latent D), StepLR(30, 0.5)
    (``train_wae_stage2.py:237-243``)."""
    step = make_wae_cognitive_step(
        cfg, stage,
        lr_schedule_enc=step_lr(1e-3, 30, 0.5, steps_per_epoch),
        lr_schedule_dec=step_lr(1e-3, 30, 0.5, steps_per_epoch),
        lr_schedule_disc=step_lr(5e-4, 30, 0.5, steps_per_epoch), mesh=mesh)
    return StepFns(lambda s, batch, noise: step.train_step(s, batch["fmri"], batch["image"]),
                   _pair_eval(step), step.generate_step)


def wae_stage2(cfg: Config, stage1_ckpt: str, *, steps_per_epoch: int, seed: int = 8,
               epoch: Optional[int] = None, device: str = "cuda",
               mesh=None) -> Built:
    """Stage-II cognitive WAE: a fresh CognitiveEncoder and latent D
    ("normal" init); the stage-I encoder becomes the frozen teacher and the
    stage-I decoder is shared frozen (``train_wae_stage2.py:196-202``)."""
    nets = init_wae_cognitive(cfg, seed=seed)
    graft_groups(nets, load_groups(stage1_ckpt, ["encoder", "decoder"], epoch,
                                   prefixes=WaeGan.PREFIXES),
                 {"decoder": "decoder", "teacher_encoder": "encoder"})
    opt = Adam(b1=0.5, b2=0.999)
    state = make_state(nets.to(resolve_device(device)),
                       {"encoder": opt, "latent_disc": opt})
    return (state, _wae_cognitive_step(cfg, 2, steps_per_epoch, mesh),
            _pair_kwargs(cfg, False, False, ()))


def wae_stage3(cfg: Config, stage2_ckpt: str, stage1_ckpt: str, *, steps_per_epoch: int,
               seed: int = 8, epoch: Optional[int] = None, device: str = "cuda",
               mesh=None) -> Built:
    """Stage-III WAE: the cognitive encoder (frozen) and decoder from stage
    II, the teacher encoder from stage I (its latest checkpoint), a fresh
    latent D (the reference rebuilds ``WaeGanCognitive``, whose ctor makes a
    new one, ``train_wae_stage3.py:212-223``); the decoder trains on the
    recon loss alone."""
    nets = init_wae_cognitive(cfg, seed=seed)
    graft_groups(nets, load_groups(stage2_ckpt, ["encoder", "decoder"], epoch,
                                   prefixes=WaeGanCognitiveTrain.PREFIXES),
                 {"encoder": "encoder", "decoder": "decoder"})
    graft_groups(nets, load_groups(stage1_ckpt, ["encoder"], prefixes=WaeGan.PREFIXES),
                 {"teacher_encoder": "encoder"})
    opt = Adam(b1=0.5, b2=0.999)
    state = make_state(nets.to(resolve_device(device)),
                       {"decoder": opt, "latent_disc": opt})
    return (state, _wae_cognitive_step(cfg, 3, steps_per_epoch, mesh),
            _pair_kwargs(cfg, False, False, ()))


# --------------------------- WAE/Dual-GAN ---------------------------


def wae_vgan_stage1(cfg: Config, *, mode: str = "vae-gan", steps_per_epoch: int,
                    seed: int = 8, device: str = "cuda",
                    mesh=None) -> Built:
    """Stage-I WAE/Dual-GAN: the VAE/GAN triplet and a latent discriminator,
    all RMSprop (``wae_vgan_stage1.py:199-200,243-250``)."""
    t = cfg.train
    step = make_wae_vgan_step(cfg, mode, lr_schedule=exponential_lr(
        t.learning_rate, t.decay_lr, steps_per_epoch), mesh=mesh)
    nets = init_wae_dual_gan(cfg, seed).to(resolve_device(device))
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=t.grad_clip)
    state = make_state(nets, {g: opt for g in WAE_DUAL_GROUPS})
    steps = StepFns(lambda s, x, noise, *gate: step.train_step(
        s, x, noise["eps"], noise["z_p"], noise["z_fake"], *gate),
        step.eval_step, step.generate_step)
    noise = (("eps", 1.0), ("z_p", 1.0), ("z_fake", t.wae_sigma))
    return state, steps, _image_kwargs(True, True, noise)


# --------------------------- experiments (ablations) ---------------------------


def exp_decoder(cfg: Config, *, steps_per_epoch: int, seed: int = 8,
                device: str = "cuda", mesh=None) -> Built:
    """The supervised decoder ablation: a fresh VoxelDecoder, Adam(0.9,
    0.999) at lr 0.01 with the per-epoch ExponentialLR (``exp_decoder.py:253``);
    no gate, no noise, the mean decoded at eval."""
    step = make_supervised_decoder_step(cfg, lr_schedule=exponential_lr(
        0.01, cfg.train.decay_lr, steps_per_epoch), mesh=mesh)
    state = make_state(init_voxel_decoder(cfg, seed).to(resolve_device(device)),
                       {"decoder": Adam(b1=0.9, b2=0.999)})
    steps = StepFns(lambda s, batch, noise: step.train_step(s, batch["fmri"], batch["image"]),
                    _pair_eval(step), None)
    return state, steps, _pair_kwargs(cfg, False, False, ())


def _exp_pair_steps(step: StepFns) -> StepFns:
    return StepFns(lambda s, batch, noise, *gate: step.train_step(
        s, batch["fmri"], batch["image"], noise["eps"], noise["z_p"], *gate),
        _pair_eval(step), step.generate_step)


def _exp_cognitive_scratch(cfg: Config, mode: str, steps_per_epoch: int, seed: int,
                           device: str, mesh=None) -> Built:
    """A fresh cognitive encoder, decoder and discriminator, RMSprop clamping
    to +-1 for each (``fmri_tpu/train/stages.py:228-246``)."""
    t = cfg.train
    step = make_cognitive_scratch_step(cfg, mode, lr_schedule=exponential_lr(
        t.learning_rate, t.decay_lr, steps_per_epoch), mesh=mesh)
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    state = make_state(init_groups(CognitiveVaeGan, cfg, seed).to(resolve_device(device)),
                       {g: opt for g in GROUPS})
    return state, _exp_pair_steps(step), _pair_kwargs(cfg, True, True, EXP_NOISE)


def exp_vae(cfg: Config, *, steps_per_epoch: int, seed: int = 8,
            device: str = "cuda", mesh=None) -> Built:
    """The cognitive Dual-VAE without distillation (``exp_vae.py``)."""
    return _exp_cognitive_scratch(cfg, "vae", steps_per_epoch, seed, device, mesh)


def exp_vgan(cfg: Config, *, steps_per_epoch: int, seed: int = 8,
             device: str = "cuda", mesh=None) -> Built:
    """The Dual-VAE/GAN on BOLD from scratch (``exp_vgan.py``)."""
    return _exp_cognitive_scratch(cfg, "vae-gan", steps_per_epoch, seed, device, mesh)


def exp_dcgan_stage1(cfg: Config, *, steps_per_epoch: int, seed: int = 8,
                     device: str = "cuda", mesh=None) -> Built:
    """The plain DCGAN on images (``exp_dcgan_stage1.py``): a fresh decoder
    and discriminator, RMSprop clamping to +-1; the step's noise is z_p,
    drawn from the step's key unsplit."""
    t = cfg.train
    step = make_dcgan_stage1_step(cfg, lr_schedule=exponential_lr(
        t.learning_rate, t.decay_lr, steps_per_epoch), mesh=mesh)
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    state = make_state(init_groups(DcGan, cfg, seed).to(resolve_device(device)),
                       {g: opt for g in DcGan.PREFIXES})
    steps = StepFns(lambda s, x, noise, *gate: step.train_step(s, x, noise["z_p"], *gate),
                    step.eval_step, step.generate_step)
    return state, steps, _image_kwargs(True, True, (("z_p", 1.0),))


def exp_dcgan_stage2(cfg: Config, stage1_ckpt: str, *, steps_per_epoch: int,
                     seed: int = 8, epoch: Optional[int] = None,
                     device: str = "cuda", mesh=None) -> Built:
    """The cognitive encoder over a DCGAN generator (``exp_dcgan_stage2.py``):
    a fresh encoder from ``seed``, the decoder and discriminator from the
    DCGAN stage-1 checkpoint (a port run's checkpoint dir or a ``.pth`` in
    ``DcGan``'s layout); the decoder (no clamp) and the discriminator (clamp
    +-1) train, the encoder is frozen."""
    t = cfg.train
    step = make_dcgan_stage2_step(cfg, lr_schedule=exponential_lr(
        t.learning_rate, t.decay_lr, steps_per_epoch), mesh=mesh)
    nets = graft_groups(init_groups(CognitiveVaeGan, cfg, seed), load_groups(
        stage1_ckpt, ["decoder", "discriminator"], epoch, prefixes=DcGan.PREFIXES),
        {"decoder": "decoder", "discriminator": "discriminator"})
    state = make_state(nets.to(resolve_device(device)), {
        "decoder": RmsProp(decay=t.rms_decay, eps=t.rms_eps),
        "discriminator": RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)})
    return state, _exp_pair_steps(step), _pair_kwargs(cfg, True, True, EXP_NOISE)


BUILDERS = {
    "vgan_stage1": vgan_stage1,
    "vgan_stage2": vgan_stage2,
    "vgan_stage3": vgan_stage3,
    "wae_stage1": wae_stage1,
    "wae_stage2": wae_stage2,
    "wae_stage3": wae_stage3,
    "wae_vgan_stage1": wae_vgan_stage1,
    "exp_decoder": exp_decoder,
    "exp_vae": exp_vae,
    "exp_vgan": exp_vgan,
    "exp_dcgan_stage1": exp_dcgan_stage1,
    "exp_dcgan_stage2": exp_dcgan_stage2,
}
