"""The WAE train steps: WAE/GAN stage I (``train_wae_stage1.py``), the
cognitive WAE stages II and III (``train_wae_stage2.py``,
``train_wae_stage3.py``) and the WAE/Dual-GAN composite
(``wae_vgan_stage1.py``).

Counterpart of ``fmri_tpu/train/steps_wae.py:36-592`` (``make_wae_stage1_step``,
``make_wae_cognitive_step``, ``make_wae_vgan_step``). Each step keeps the
reference's two phases per batch: (1) the latent discriminator is updated
with the generator frozen, then (2) the generator is updated against the
*updated* discriminator.

The reference recomputes the encoder for each phase, so its BatchNorm
running statistics tick again on the same batch. A step here runs the
encoder forward once and replays the extra ticks analytically
(``train/common.py::bn_extra_ticks``), as the JAX step does; only stage I's
naive backward recomputes the encoder, as the JAX naive step does, and its
two real ticks need no replay.

* Stage I: the latent D (Adam at 0.5 x lr) on z_real = enc(x).mu against
  z_fake ~ N(0, sigma^2); then encoder and decoder (Adam) on the summed
  recon loss plus the penalty. ``backward='spliced'``: one encoder forward,
  the recon and penalty cotangents summed at mu; ``'naive'``: the phase-2
  recompute.
* Stages II and III (Adam(0.5, 0.999), default lrs 1e-3 / 1e-3 / 5e-4):
  the frozen stage-I teacher runs in train mode under ``no_grad`` (its
  BatchNorm ticks); stage II decodes the teacher's mu through the shared
  decoder (the result feeds no loss but ticks the decoder's BatchNorm).
  The latent D scores the teacher as "real" and the cognitive encoder as
  "fake", verbatim. Stage II trains the encoder on mean recon + mean
  penalty, stage III the decoder on the recon alone (the penalty is
  logged only).
* WAE/Dual-GAN (modes and backwards of ``steps_vgan.py``'s stage-I step):
  the stage-I VAE/GAN gradients; the latent-D RMSprop update on mu against
  z_fake with weight ``wae_vgan_lam``; the penalty against the updated
  latent D added to the encoder's gradient (the spliced backward folds its
  cotangent at mu into the one encoder backward, where the JAX step pulls
  it through a second ``enc_vjp``: the same sum by linearity); the
  reference's zero-grad ``optimizer_decoder.step()``, one RMSprop moment
  decay before the gated decoder update; two extra encoder ticks; and the
  stats-only third decode of mu, which cannot be replayed analytically.
  ``'dcgan'`` leaves the encoder alone.

Noise comes from the caller (``z_fake`` already scaled by sigma, and for
WAE/Dual-GAN ``eps`` and ``z_p``). The state is updated in place and
returned with the metrics, which stay on the device under the JAX keys.
"""

from __future__ import annotations

from typing import Callable

import torch

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.losses.gan_losses import (
    equilibrium_gate, wae_disc_losses, wae_penalty_mean, wae_penalty_sum,
    wae_recon_mean, wae_recon_sum,
)
from fmri_tpu_torch.train.common import bn_extra_ticks, bn_stats, gate_float
from fmri_tpu_torch.train.optim import Adam, RmsProp
from fmri_tpu_torch.train.state import TrainState
from fmri_tpu_torch.train.steps_vgan import (
    StepFns, _apply_updates, _default_lr, _metrics, _named, _scalar, eval_step,
    generate_step, stage1_grads,
)


def _params(nets, name: str):
    return list(nets.group(name).values())


def _latent_d_step(disc, opt, opt_state, d_real_in, d_fake_in, lam, lr):
    """Phase 1: the latent discriminator ``disc``'s two losses on detached
    inputs, its gradient and its (ungated) update, in place. Returns
    (loss_fake, loss_real)."""
    ld = dict(disc.named_parameters())
    loss_fake, loss_real = wae_disc_losses(disc(d_real_in), disc(d_fake_in), lam)
    grads = torch.autograd.grad(loss_fake + loss_real, list(ld.values()))
    opt.update(dict(zip(ld, grads)), opt_state, ld, lr, 1.0)
    return loss_fake.detach(), loss_real.detach()


@torch.no_grad()
def wae_eval_step(state: TrainState, x: torch.Tensor,
                  eps: torch.Tensor | None = None) -> torch.Tensor:
    """The WAE eval: decode the mean latent with running statistics
    (``WaeGan.forward``'s eval branch, ``vae_gan.py:490-493``); ``eps`` is
    ignored, as the JAX ``eval_step`` takes no sample."""
    return eval_step(state, x)


def make_wae_stage1_step(cfg: Config, lr_schedule: Callable | None = None,
                         backward: str = "spliced") -> StepFns:
    """``StepFns`` of WAE/GAN stage I on a
    :class:`~fmri_tpu_torch.train.state.WaeGan` with Adam moments
    (:func:`~fmri_tpu_torch.train.state.make_wae_state`).
    ``train_step(state, x, z_fake)``: NHWC images in [-1, 1] and prior draws
    z_fake ~ N(0, ``wae_sigma``^2) [B, latent]."""
    if backward not in ("spliced", "naive"):
        raise ValueError(f"backward must be 'spliced' or 'naive', got {backward!r}")
    t = cfg.train
    opt = Adam(b1=t.adam_b1, b2=t.adam_b2)
    lr_schedule = _default_lr(cfg, lr_schedule)
    lam = t.wae_lambda

    def train_step(state: TrainState, x: torch.Tensor, z_fake: torch.Tensor):
        nets = state.nets
        nets.train()
        b = x.shape[0]
        lr = lr_schedule(state.step)
        enc_p, dec_p = _params(nets, "encoder"), _params(nets, "decoder")
        spliced = backward == "spliced"
        before = bn_stats(nets.encoder) if spliced else None

        # phase 1: the latent D, the encoder and decoder frozen
        with torch.set_grad_enabled(spliced):
            mu, _ = nets.encoder(x)
        loss_fake, loss_real = _latent_d_step(
            nets.discriminator, opt, state.opt_state["latent_disc"], mu.detach(), z_fake,
            lam, 0.5 * lr)

        # phase 2: encoder and decoder against the updated D
        if spliced:
            mu_in = mu.detach().requires_grad_()
            x_recon = nets.decoder(mu_in)
            loss_recon = wae_recon_sum(x_recon.detach(), x)
            g = torch.autograd.grad(x_recon, dec_p + [mu_in], x_recon.detach() - x)
            g_dec, gmu_rec = g[:-1], g[-1]
            mu_p = mu.detach().requires_grad_()
            loss_pen = wae_penalty_sum(nets.discriminator(mu_p), lam)
            gmu_pen, = torch.autograd.grad(loss_pen, mu_p)
            g_enc = torch.autograd.grad(mu, enc_p, gmu_rec + gmu_pen,
                                        materialize_grads=True)  # l_var: 0
        else:
            mu2, _ = nets.encoder(x)
            x_recon = nets.decoder(mu2)
            loss_recon = wae_recon_sum(x_recon, x)
            loss_pen = wae_penalty_sum(nets.discriminator(mu2), lam)
            g = torch.autograd.grad(loss_recon + loss_pen, enc_p + dec_p,
                                    materialize_grads=True)
            g_enc, g_dec = g[:len(enc_p)], g[len(enc_p):]

        _apply_updates(opt, state, {"encoder": _named(nets, "encoder", g_enc),
                                    "decoder": _named(nets, "decoder", g_dec)},
                       lr, {"encoder": 1.0, "decoder": 1.0})
        if spliced:  # the reference's phase-2 recompute ticks the encoder again
            bn_extra_ticks(nets.encoder, before, 1)
        state.step += 1
        return state, {"loss_reconstruction": loss_recon.detach() / b,
                       "loss_penalty": loss_pen.detach() / b,
                       "loss_discriminator_fake": loss_fake / b,
                       "loss_discriminator_real": loss_real / b, "lr": lr}

    return StepFns(train_step, wae_eval_step, generate_step)


def make_wae_cognitive_step(cfg: Config, stage: int,
                            lr_schedule_enc: Callable | None = None,
                            lr_schedule_dec: Callable | None = None,
                            lr_schedule_disc: Callable | None = None) -> StepFns:
    """``StepFns`` of the cognitive WAE stage 2 or 3 on a
    :class:`~fmri_tpu_torch.train.state.WaeGanCognitiveTrain`
    (:func:`~fmri_tpu_torch.train.state.make_wae_cognitive_state`).
    ``train_step(state, fmri, image)``: fMRI [B, V] and NHWC images in
    [-1, 1]; the step draws no noise. The schedules default to the
    reference's hard-coded lrs, 1e-3 (encoder, decoder) and 5e-4 (latent D),
    ignoring ``cfg.train.learning_rate`` (``train_wae_stage2.py:237-243``)."""
    if stage not in (2, 3):
        raise ValueError(f"stage must be 2 or 3, got {stage!r}")
    opt = Adam(b1=0.5, b2=0.999)
    lam = cfg.train.wae_lambda

    def constant(lr):
        return lambda step: _scalar(lr, step.device)

    lr_enc = lr_schedule_enc or constant(1e-3)
    lr_dec = lr_schedule_dec or constant(1e-3)
    lr_disc = lr_schedule_disc or constant(5e-4)

    def train_step(state: TrainState, fmri: torch.Tensor, image: torch.Tensor):
        nets = state.nets
        nets.train()
        b = fmri.shape[0]
        with torch.no_grad():  # the frozen teacher, in train mode: it ticks
            mu_teacher, _ = nets.teacher_encoder(image)
            if stage == 2:  # gt reconstruction: no loss, one decoder tick
                nets.decoder(mu_teacher)
        before = bn_stats(nets.encoder)
        with torch.set_grad_enabled(stage == 2):
            mu, _ = nets.encoder(fmri)

        # phase 1: teacher latents "real", cognitive latents "fake"
        loss_fake, loss_real = _latent_d_step(
            nets.discriminator, opt, state.opt_state["latent_disc"], mu_teacher,
            mu.detach(), lam, lr_disc(state.step))

        # phase 2 against the updated D
        loss_recon = wae_recon_mean(nets.decoder(mu), image)
        if stage == 2:
            loss_pen = wae_penalty_mean(nets.discriminator(mu), lam)
            name, lr, loss = "encoder", lr_enc(state.step), loss_recon + loss_pen
        else:
            with torch.no_grad():  # logged only (train_wae_stage3.py:344)
                loss_pen = wae_penalty_mean(nets.discriminator(mu), lam)
            name, lr, loss = "decoder", lr_dec(state.step), loss_recon
        grads = torch.autograd.grad(loss, _params(nets, name), materialize_grads=True)
        opt.update(_named(nets, name, grads), state.opt_state[name], nets.group(name), lr)
        bn_extra_ticks(nets.encoder, before, 1)  # the phase-2 recompute's tick
        state.step += 1
        return state, {"loss_reconstruction": loss_recon.detach(),
                       "loss_penalty": loss_pen.detach(),
                       "loss_discriminator_fake": loss_fake / b,
                       "loss_discriminator_real": loss_real / b}

    return StepFns(train_step, wae_eval_step, generate_step)


def make_wae_vgan_step(cfg: Config, mode: str = "vae-gan",
                       lr_schedule: Callable | None = None,
                       backward: str = "spliced") -> StepFns:
    """``StepFns`` of WAE/Dual-GAN on a
    :class:`~fmri_tpu_torch.train.state.WaeDualGan` with RMSprop moments
    (:func:`~fmri_tpu_torch.train.state.make_wae_dual_gan_state`).
    ``train_step(state, x, eps, z_p, z_fake, margin, equilibrium,
    lambda_mse)``: NHWC images in [-1, 1], the reparameterisation noise, the
    prior draws and z_fake ~ N(0, ``wae_sigma``^2), each [B, latent]."""
    grads_fn = stage1_grads(cfg, mode, backward)
    t = cfg.train
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=t.grad_clip)
    lr_schedule = _default_lr(cfg, lr_schedule)
    # not wae_lambda: this trainer's latent-D weight is its --lam flag, 1.0
    # (wae_vgan_stage1.py:87,390-391,411)
    lam = t.wae_vgan_lam

    def train_step(state: TrainState, x: torch.Tensor, eps: torch.Tensor,
                   z_p: torch.Tensor, z_fake: torch.Tensor, margin, equilibrium,
                   lambda_mse):
        nets = state.nets
        nets.train()
        dev, b = x.device, x.shape[0]
        lr = lr_schedule(state.step)
        before = bn_stats(nets.encoder)
        out = {}

        def penalty_cot(mu):
            """The latent-D update on mu, then the penalty against the
            updated D and its cotangent at mu."""
            out["mu"] = mu
            out["fake"], out["real"] = _latent_d_step(
                nets.latent_disc, opt, state.opt_state["latent_disc"], mu, z_fake, lam, lr)
            mu_p = mu.requires_grad_()
            loss_pen = wae_penalty_sum(nets.latent_disc(mu_p), lam)
            out["pen"] = loss_pen.detach()
            return torch.autograd.grad(loss_pen, mu_p)[0]

        grads, terms, h = grads_fn(nets, x, eps, z_p, _scalar(lambda_mse, dev),
                                   penalty_cot)
        with torch.no_grad():  # the penalty phase's decode of mu: a third tick
            nets.decoder(out["mu"].detach())
        # the reference's optimizer_decoder.step() with zero grads (:417)
        dec = nets.group("decoder")
        opt.update({k: torch.zeros_like(p) for k, p in dec.items()},
                   state.opt_state["decoder"], dec, lr, 1.0)
        dec_gate, dis_gate = (gate_float(g) for g in equilibrium_gate(
            terms, _scalar(equilibrium, dev), _scalar(margin, dev),
            init_dis=(mode != "vae")))
        _apply_updates(opt, state, grads, lr, {"encoder": 1.0, "decoder": dec_gate,
                                               "discriminator": dis_gate})
        bn_extra_ticks(nets.encoder, before, 2)  # the D and penalty phases' ticks
        state.step += 1
        metrics = _metrics(h, b, dec_gate, dis_gate, lr)
        metrics.update(loss_penalty=out["pen"] / b,
                       loss_discriminator_fake=out["fake"] / b,
                       loss_discriminator_real=out["real"] / b)
        return state, metrics

    return StepFns(train_step, eval_step, generate_step)
