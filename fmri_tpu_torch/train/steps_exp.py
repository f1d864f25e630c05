"""Train steps of the thesis ablation experiments (reference
``experiments/``): the port's counterpart of ``fmri_tpu/train/steps_exp.py``.

* supervised decoder (``exp_decoder.py``): fMRI -> image through a
  VoxelDecoder, pure MSE, Adam;
* the cognitive VAE(/GAN) from scratch (``exp_vae.py``, mode ``'vae'``;
  ``exp_vgan.py``, mode ``'vae-gan'``): the Dual-VAE/GAN trained on BOLD
  with no teacher;
* DCGAN stage 1 (``exp_dcgan_stage1.py``): a plain DCGAN on images;
* DCGAN stage 2 (``exp_dcgan_stage2.py``): the cognitive graph over the
  stage-1 generator.

Every gradient is taken at the step's original weights from one forward,
one backward per trained head, as the JAX steps' ``jax.vjp`` with one-hot
cotangents (the naive backward of ``train/steps_vgan.py``); the updates
follow once every gradient exists. The reference's quirks, which the JAX
package pins (``tests/test_update_parity_exp.py``), are kept:

* ``'vae'`` (``exp_vae.py:343-352``): the gate block is commented out, so
  the decoder always trains and the discriminator never does; its
  gradient is not taken and its moments stay as they were, though its
  BatchNorm statistics tick in the forward. The encoder's gradient is
  clamped to +-1, the decoder's is not (``:366``);
* ``'vae-gan'`` (``exp_vgan.py:265-313``): all three groups clamped to
  +-1, the standard equilibrium gate;
* DCGAN stage 1: the discriminator sees ``concat(x, x_tilde, x_tilde)``
  from one decode; the gate compares the script's own means,
  ``mean(-log(D(x) + eps))`` and ``mean(-log(D(x_tilde) + eps))``, with
  the both-off rescue (``:286-309``); the decoder's gradient is that of
  ``loss_dec + train_dis * loss_dis`` (the reference zeroes only the
  discriminator's grads after its backward, ``:313-327``), the gate folded
  into the loss on the device, no host branch; its eval step decodes the
  eps it is given as prior draws and ignores its input;
* DCGAN stage 2: the encoder is frozen (no gradient, no optimizer) but
  runs in train mode, so its BatchNorm statistics tick; the decoder trains
  unclamped (``:344``), the discriminator clamped (``:352``); the two
  decodes tick the decoder's statistics in order, x_tilde then x_p.

Noise comes from the caller as tensors (tests inject the JAX draws). The
state is updated in place and returned with the metrics, which stay on
the device under the JAX keys.

``mesh``: as in ``steps_vgan.py`` (the supervised decoder's mean loss is
pulled back as 1/D of this rank's; the DCGAN stage-1 gate compares the
global batch's means).
"""

from __future__ import annotations

from typing import Callable

import torch

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.losses.gan_losses import (
    LOG_EPS, combine_mode, equilibrium_gate, vaegan_terms,
)
from fmri_tpu_torch.models.nets import reparameterize
from fmri_tpu_torch.train.common import gate_float
from fmri_tpu_torch.train.optim import Adam, RmsProp
from fmri_tpu_torch.train.state import TrainState
from fmri_tpu_torch.train.steps_vgan import (
    StepFns, _data, _data_sums, _default_lr, _head_sums, _metrics, _named, _on_mesh,
    _reduce_grads, _scalar, _split_triplet, _step_sums, eval_step, generate_step,
)

SCRATCH_MODES = ("vae", "vae-gan")


def _grads(nets, heads, names, mesh=None):
    """{group: gradient of its head} for each (head, group) pair, every
    gradient from the same forward graph, summed over the data group."""
    out = {}
    for i, (head, name) in enumerate(zip(heads, names)):
        out[name] = _named(nets, name, torch.autograd.grad(
            head, list(nets.group(name).values()), retain_graph=i < len(names) - 1))
    return _reduce_grads(out, mesh)


def _update(opt, state: TrainState, name: str, grads, lr, gate=1.0) -> None:
    opt.update(grads[name], state.opt_state[name], state.nets.group(name), lr, gate)


def _cognitive_forward(nets, fmri, image, eps, z_p, encoder_grad: bool):
    """The cognitive encoder (train mode), then the decodes of z and z_p in
    that order, then one discriminator pass over [image, x_tilde, x_p]:
    (mu, logvar, x_tilde, split discriminator outputs)."""
    with torch.set_grad_enabled(encoder_grad):
        mu, lv = nets.encoder(fmri)
    x_tilde = nets.decoder(reparameterize(mu, lv, eps))
    x_p = nets.decoder(z_p)
    feats, score = nets.discriminator(torch.cat([image, x_tilde, x_p]))
    return mu, lv, x_tilde, _split_triplet(feats, score, fmri.shape[0])


@torch.no_grad()
def _decoder_eval(state: TrainState, fmri: torch.Tensor, eps=None) -> torch.Tensor:
    """The supervised decoder with running statistics; ``eps`` is unused
    (the step draws no noise)."""
    state.nets.eval()
    return state.nets.decoder(fmri)


def make_supervised_decoder_step(cfg: Config, lr_schedule: Callable | None = None,
                                 mesh=None) -> StepFns:
    """``loss = mean((image - VoxelDecoder(fmri))^2)``, Adam(0.9, 0.999) at
    lr 0.01 by default (``exp_decoder.py:213,253-260``). ``train_step(state,
    fmri, image)``; no generate step: the decoder's input is the voxels, not
    a latent (``exp_decoder.py:172-174``)."""
    opt = Adam(b1=0.9, b2=0.999)
    if lr_schedule is None:
        lr_schedule = lambda step: _scalar(0.01, step.device)  # noqa: E731

    data = _data(mesh)

    def train_step(state: TrainState, fmri: torch.Tensor, image: torch.Tensor):
        nets = state.nets
        nets.train()
        loss = torch.mean((image - nets.decoder(fmri)) ** 2)
        grads = _grads(nets, [loss / data if data > 1 else loss], ["decoder"], mesh)
        lr = lr_schedule(state.step)
        _update(opt, state, "decoder", grads, lr)
        state.step += 1
        return state, {"loss_decoder": _data_sums(mesh, loss)[0] / data, "lr": lr}

    return StepFns(_on_mesh(train_step, mesh), _decoder_eval, None)


def make_cognitive_scratch_step(cfg: Config, mode: str = "vae-gan",
                                lr_schedule: Callable | None = None,
                                mesh=None) -> StepFns:
    """The cognitive Dual-VAE(/GAN) from scratch on BOLD
    (``VaeGanCognitive(teacher_net=None, stage=3)``, ``exp_vgan.py:165-167``,
    ``exp_vae.py:199-201``) on a
    :class:`~fmri_tpu_torch.train.state.CognitiveVaeGan`. ``train_step(state,
    fmri, image, eps, z_p, margin, equilibrium, lambda_mse)``."""
    if mode not in SCRATCH_MODES:
        raise ValueError(f"mode must be one of {SCRATCH_MODES}, got {mode!r}")
    t = cfg.train
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    opt_dec = opt if mode == "vae-gan" else RmsProp(decay=t.rms_decay, eps=t.rms_eps)
    trained = ("encoder", "decoder", "discriminator")[:3 if mode == "vae-gan" else 2]
    lr_schedule = _default_lr(cfg, lr_schedule)

    def train_step(state: TrainState, fmri, image, eps, z_p, margin, equilibrium,
                   lambda_mse):
        nets = state.nets
        nets.train()
        dev, b = fmri.device, fmri.shape[0]
        mu, lv, x_tilde, split = _cognitive_forward(nets, fmri, image, eps, z_p, True)
        terms = vaegan_terms(image, x_tilde, *split, mu, lv)
        h = combine_mode(terms, mode, lambda_mse=_scalar(lambda_mse, dev), beta=t.beta,
                         batch_size=b * _data(mesh))
        grads = _grads(nets, [getattr(h, g) for g in trained], trained, mesh)
        means, sums = _head_sums(mesh, terms, h)
        if mode == "vae":  # exp_vae.py:343-352: the gate is commented out
            dec_gate, dis_gate = _scalar(1.0, dev), _scalar(0.0, dev)
        else:
            dec_gate, dis_gate = (gate_float(g) for g in equilibrium_gate(
                terms, _scalar(equilibrium, dev), _scalar(margin, dev), means=means))
        lr = lr_schedule(state.step)
        _update(opt, state, "encoder", grads, lr)
        _update(opt_dec, state, "decoder", grads, lr, dec_gate)
        if mode == "vae-gan":
            _update(opt, state, "discriminator", grads, lr, dis_gate)
        state.step += 1
        return state, _metrics(sums, b * _data(mesh), dec_gate, dis_gate, lr)

    return StepFns(_on_mesh(train_step, mesh), eval_step, generate_step)


def make_dcgan_stage1_step(cfg: Config, lr_schedule: Callable | None = None,
                           mesh=None) -> StepFns:
    """Plain DCGAN on images (``exp_dcgan_stage1.py``) on a
    :class:`~fmri_tpu_torch.train.state.DcGan`: ``L_D = sum -log(D(x) + e)
    + sum -log(1 - D(x_tilde) + e)``, ``L_G = sum -log(D(x_tilde) + e)``
    (``:287-291``); the script's equilibrium gate; RMSprop clamping to +-1.
    ``train_step(state, x, z_p, margin, equilibrium, lambda_mse)``
    (``lambda_mse`` unused, so every gated step takes the same three);
    ``eval_step(state, x, eps)`` decodes ``eps``, the prior draws the
    ``Trainer`` hands an eval step that samples (``vae_gan.py:615-618``;
    the JAX step draws them from its key)."""
    t = cfg.train
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    lr_schedule = _default_lr(cfg, lr_schedule)

    def train_step(state: TrainState, x, z_p, margin, equilibrium, lambda_mse):
        nets = state.nets
        nets.train()
        dev, b = x.device, x.shape[0]
        x_tilde = nets.decoder(z_p)
        _, score = nets.discriminator(torch.cat([x, x_tilde, x_tilde]))
        so, sp, ss = score[:b], score[b:2 * b], score[2 * b:]
        bce_orig = -torch.log(so + LOG_EPS)
        bce_pred = -torch.log(sp + LOG_EPS)  # the generator fools D
        loss_dis = torch.sum(bce_orig) + torch.sum(-torch.log(1.0 - ss + LOG_EPS))
        loss_dec = torch.sum(bce_pred)
        (m_orig, m_pred), (dec, dis) = _step_sums(mesh, bce_orig, bce_pred, loss_dec,
                                                  loss_dis)
        eq, mg = _scalar(equilibrium, dev), _scalar(margin, dev)
        train_dis = ~((m_orig < eq - mg) | (m_pred < eq - mg))
        train_dec = ~((m_orig > eq + mg) | (m_pred > eq + mg))
        both_off = ~train_dis & ~train_dec
        dis_gate, dec_gate = gate_float(train_dis | both_off), gate_float(train_dec | both_off)
        grads = _grads(nets, [loss_dis, loss_dec + dis_gate * loss_dis],
                       ["discriminator", "decoder"], mesh)
        lr = lr_schedule(state.step)
        _update(opt, state, "discriminator", grads, lr, dis_gate)
        _update(opt, state, "decoder", grads, lr, dec_gate)
        state.step += 1
        n = b * _data(mesh)
        return state, {"loss_decoder": dec / n, "loss_discriminator": dis / n,
                       "train_dec": dec_gate, "train_dis": dis_gate, "lr": lr}

    def dcgan_eval(state: TrainState, x, eps: torch.Tensor) -> torch.Tensor:
        return generate_step(state, eps)

    return StepFns(_on_mesh(train_step, mesh), dcgan_eval, generate_step)


def make_dcgan_stage2_step(cfg: Config, lr_schedule: Callable | None = None,
                           mesh=None) -> StepFns:
    """The cognitive graph over a stage-1 DCGAN generator
    (``exp_dcgan_stage2.py``) on a
    :class:`~fmri_tpu_torch.train.state.CognitiveVaeGan`: the ``'vae-gan'``
    losses; the decoder (gated, no clamp) and the discriminator (gated,
    clamp +-1) train; the encoder is frozen (``requires_grad=False`` at
    ``:187-188``, its backward commented out at ``:336-338``) and still
    ticks its BatchNorm. ``train_step(state, fmri, image, eps, z_p, margin,
    equilibrium, lambda_mse)``."""
    t = cfg.train
    opt_dec = RmsProp(decay=t.rms_decay, eps=t.rms_eps)
    opt_dis = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    lr_schedule = _default_lr(cfg, lr_schedule)

    def train_step(state: TrainState, fmri, image, eps, z_p, margin, equilibrium,
                   lambda_mse):
        nets = state.nets
        nets.train()
        dev, b = fmri.device, fmri.shape[0]
        mu, lv, x_tilde, split = _cognitive_forward(nets, fmri, image, eps, z_p, False)
        terms = vaegan_terms(image, x_tilde, *split, mu, lv)
        h = combine_mode(terms, "vae-gan", lambda_mse=_scalar(lambda_mse, dev),
                         beta=t.beta, batch_size=b * _data(mesh))
        grads = _grads(nets, [h.decoder, h.discriminator], ["decoder", "discriminator"],
                       mesh)
        means, sums = _head_sums(mesh, terms, h)
        dec_gate, dis_gate = (gate_float(g) for g in equilibrium_gate(
            terms, _scalar(equilibrium, dev), _scalar(margin, dev), means=means))
        lr = lr_schedule(state.step)
        _update(opt_dec, state, "decoder", grads, lr, dec_gate)
        _update(opt_dis, state, "discriminator", grads, lr, dis_gate)
        state.step += 1
        return state, _metrics(sums, b * _data(mesh), dec_gate, dis_gate, lr)

    return StepFns(_on_mesh(train_step, mesh), eval_step, generate_step)
