"""The stage-I Dual-VAE/GAN train step (``train_vgan_stage1.py``), mode
``'vae-gan'``.

Counterpart of ``fmri_tpu/train/steps_vgan.py:42-293``
(``make_vgan_stage1_step``). One step:

1. VisualEncoder in train mode, then z = mu + eps * exp(logvar / 2);
2. two sequential Decoder passes, x_tilde = dec(z) and x_p = dec(z_p) (two
   BatchNorm ticks, as the reference);
3. one ImageDiscriminator pass over the 3B concat [x, x_tilde, x_p], with
   the pre-BN feature tap at ``recon_level``;
4. ``vaegan_terms``, ``combine_mode`` and ``equilibrium_gate``;
5. the backward (below);
6. three gated RMSprop updates, all taken after the three gradients exist,
   so every head's gradient is taken at the original weights.

``backward='spliced'`` (the default) cuts the graph at z and at
(x_tilde, x_p) and pulls the cotangents of the two base losses through each
segment with ``torch.autograd.grad`` on one retained graph: the
feature-matching B basis and the GAN C basis through the discriminator, the
decoder head's combination of them through the decoder, then the B basis
back to z and through the encoder with the KL term. By linearity this gives
the naive gradients (``backward='naive'``: one forward and three full
pullbacks, kept for the equivalence test) with fewer segment traversals.

With ``pallas_backward`` each conv's weight grad is its own autograd node
(``ops/conv.py::_WeightGrad``), so the B-basis pullback through the
discriminator and the z pullback through the decoder, which ask for no
weight, launch no weight grad, as XLA's DCE prunes that work in the JAX
step: one launch per conv/deconv weight use, 15 per res64 step.

Noise comes from the caller: ``train_step(state, x, eps, z_p, margin,
equilibrium, lambda_mse)`` takes eps and z_p as tensors, so tests inject the
JAX draws. The state is updated in place and returned with the metrics,
which stay on the device under the JAX keys. Only ``mode='vae-gan'`` is
ported; 'vae', 'beta-vae' and 'dcgan' are ROADMAP slice 3.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.losses.gan_losses import (
    LOG_EPS, combine_mode, equilibrium_gate, vaegan_terms,
)
from fmri_tpu_torch.models.nets import reparameterize
from fmri_tpu_torch.train.common import gate_float
from fmri_tpu_torch.train.optim import RmsProp
from fmri_tpu_torch.train.state import TrainState

MODES = ("vae-gan", "vae", "beta-vae", "dcgan")


class StepFns(NamedTuple):
    train_step: Callable
    eval_step: Callable
    generate_step: Callable


def _split_triplet(feats, score, b):
    return (feats[:b], feats[b:2 * b], score[:b], score[b:2 * b], score[2 * b:])


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def make_vgan_stage1_step(cfg: Config, mode: str = "vae-gan",
                          lr_schedule: Callable | None = None,
                          backward: str = "spliced") -> StepFns:
    """``StepFns(train_step, eval_step, generate_step)`` of the stage-I step.
    ``lr_schedule(step) -> lr`` defaults to the constant
    ``cfg.train.learning_rate``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if mode != "vae-gan":
        raise NotImplementedError(
            f"stage-I mode {mode!r} is not ported yet (ROADMAP slice 3); "
            "the port runs 'vae-gan'")
    if backward not in ("spliced", "naive"):
        raise ValueError(f"backward must be 'spliced' or 'naive', got {backward!r}")
    t = cfg.train
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=t.grad_clip)
    if lr_schedule is None:
        lr_schedule = lambda step: _scalar(t.learning_rate, step.device)  # noqa: E731

    def heads(x, x_tilde, feats, score, mu, lv, lambda_mse):
        b = x.shape[0]
        terms = vaegan_terms(x, x_tilde, *_split_triplet(feats, score, b), mu, lv)
        return terms, combine_mode(terms, mode, lambda_mse=lambda_mse,
                                   beta=t.beta, batch_size=b)

    def grads_naive(nets, x, eps, z_p, lambda_mse):
        mu, lv = nets.encoder(x)
        x_tilde = nets.decoder(reparameterize(mu, lv, eps))
        x_p = nets.decoder(z_p)
        feats, score = nets.discriminator(torch.cat([x, x_tilde, x_p]))
        terms, h = heads(x, x_tilde, feats, score, mu, lv, lambda_mse)
        out = []
        for i, (name, loss) in enumerate(zip(("encoder", "decoder", "discriminator"),
                                             (h.encoder, h.decoder, h.discriminator))):
            params = nets.group(name)
            g = torch.autograd.grad(loss, list(params.values()), retain_graph=i < 2)
            out.append(dict(zip(params, g)))
        return (*out, terms, h)

    def grads_spliced(nets, x, eps, z_p, lambda_mse):
        b = x.shape[0]
        enc_p, dec_p, dis_p = (list(nets.group(n).values()) for n in
                               ("encoder", "decoder", "discriminator"))
        mu, lv = nets.encoder(x)
        z = reparameterize(mu, lv, eps)
        z_in = z.detach().requires_grad_()
        x_tilde, x_p = nets.decoder(z_in), nets.decoder(z_p)
        xt_in = x_tilde.detach().requires_grad_()
        xp_in = x_p.detach().requires_grad_()
        feats, score = nets.discriminator(torch.cat([x, xt_in, xp_in]))
        with torch.no_grad():
            terms, h = heads(x, x_tilde, feats, score, mu, lv, lambda_mse)

        # cheap tail cotangents on the base losses
        with torch.enable_grad():
            s = score.detach().requires_grad_()
            c_loss = (torch.sum(-torch.log(s[:b] + LOG_EPS))
                      + torch.sum(-torch.log(1.0 - s[2 * b:] + LOG_EPS))
                      + torch.sum(-torch.log(1.0 - s[b:2 * b] + LOG_EPS)))
            cot_score_c, = torch.autograd.grad(c_loss, s)
            f = feats.detach().requires_grad_()
            b_loss = torch.sum(0.5 * (f[:b] - f[b:2 * b]) ** 2)
            cot_feats_b, = torch.autograd.grad(b_loss, f)

        # discriminator: C basis (the discriminator head) and B basis
        g = torch.autograd.grad(score, dis_p + [xt_in, xp_in], cot_score_c,
                                retain_graph=True)
        g_dis, gxt_c, gxp_c = g[:-2], g[-2], g[-1]
        gxt_b, gxp_b = torch.autograd.grad(feats, [xt_in, xp_in], cot_feats_b)
        lam = lambda_mse
        cot_dec = (lam * gxt_b - (1.0 - lam) * gxt_c,
                   lam * gxp_b - (1.0 - lam) * gxp_c)

        # decoder: the head's combination, then the B basis back to z
        g_dec = torch.autograd.grad([x_tilde, x_p], dec_p, cot_dec,
                                    retain_graph=True)
        gz, = torch.autograd.grad(x_tilde, z_in, gxt_b)
        # encoder: A = sum kld gives dA/dmu = mu, dA/dlogvar = (exp(lv) - 1) / 2
        g_enc = torch.autograd.grad(
            [z, mu, lv], enc_p,
            [gz, mu.detach(), 0.5 * (torch.exp(lv.detach()) - 1.0)])
        named = [dict(zip(nets.group(n), gs)) for n, gs in
                 (("encoder", g_enc), ("decoder", g_dec), ("discriminator", g_dis))]
        return (*named, terms, h)

    grads_fn = grads_spliced if backward == "spliced" else grads_naive

    def train_step(state: TrainState, x: torch.Tensor, eps: torch.Tensor,
                   z_p: torch.Tensor, margin, equilibrium, lambda_mse):
        """One step on NHWC images x in [-1, 1] with the reparameterisation
        noise eps and prior draws z_p ([B, latent] each). Returns
        ``(state, metrics)``; the state is the same object, updated."""
        nets = state.nets
        nets.train()
        dev = x.device
        b = x.shape[0]
        lam = _scalar(lambda_mse, dev)
        g_enc, g_dec, g_dis, terms, h = grads_fn(nets, x, eps, z_p, lam)
        dec_gate, dis_gate = equilibrium_gate(
            terms, _scalar(equilibrium, dev), _scalar(margin, dev))
        lr = lr_schedule(state.step)
        gates = {"encoder": 1.0, "decoder": gate_float(dec_gate),
                 "discriminator": gate_float(dis_gate)}
        for name, grads in (("encoder", g_enc), ("decoder", g_dec),
                            ("discriminator", g_dis)):
            opt.update(grads, state.opt_state[name], nets.group(name), lr,
                       gates[name])
        state.step += 1
        metrics = {
            "loss_encoder": h.encoder.detach() / b,
            "loss_decoder": h.decoder.detach() / b,
            "loss_discriminator": h.discriminator.detach() / b,
            "loss_reconstruction": h.nle_sum.detach() / b,
            "train_dec": gates["decoder"],
            "train_dis": gates["discriminator"],
            "lr": lr,
        }
        return state, metrics

    @torch.no_grad()
    def eval_step(state: TrainState, x: torch.Tensor,
                  eps: torch.Tensor | None = None) -> torch.Tensor:
        """Eval reconstruction with BatchNorm running statistics
        (``vae_gan.py:288-297``): z = mu, or mu + eps * exp(logvar / 2)."""
        nets = state.nets
        nets.eval()
        mu, lv = nets.encoder(x)
        z = mu if eps is None else reparameterize(mu, lv, eps)
        return nets.decoder(z)

    @torch.no_grad()
    def generate_step(state: TrainState, z_p: torch.Tensor) -> torch.Tensor:
        """Decode prior draws z_p ~ N(0, I) with running statistics
        (``vae_gan.py:294-297``)."""
        state.nets.eval()
        return state.nets.decoder(z_p)

    return StepFns(train_step, eval_step, generate_step)
