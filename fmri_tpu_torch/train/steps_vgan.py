"""The Dual-VAE/GAN train steps: stage I (``train_vgan_stage1.py``) and the
cognitive stages II and III (``train_vgan_stage2.py``,
``train_vgan_stage3.py``), in the modes ``'vae-gan'``, ``'vae'``,
``'beta-vae'`` and ``'dcgan'``.

Counterpart of ``fmri_tpu/train/steps_vgan.py:67-611``
(``make_vgan_stage1_step``, ``make_vgan_cognitive_step``). One stage-I step:

1. VisualEncoder in train mode, then z = mu + eps * exp(logvar / 2);
2. the decoder over z and the prior draws z_p: two sequential passes (two
   BatchNorm ticks, as the reference), or with
   ``ModelConfig.fused_decoder_batch`` one pass over both with ``vsplit=2``
   BatchNorm, the same math;
3. one ImageDiscriminator pass over the 3B concat [x, x_tilde, x_p], with
   the pre-BN feature tap at ``recon_level``;
4. ``vaegan_terms``, ``combine_mode`` and ``equilibrium_gate``;
5. the backward (below);
6. gated RMSprop updates, all taken after every gradient exists, so every
   head's gradient is taken at the original weights. ``'dcgan'`` leaves the
   encoder and its moments alone.

Stage II trains the cognitive encoder and the discriminator with the
decoder frozen and no gate; with ``use_teacher`` the frozen stage-I encoder
encodes the image (in train mode: its BatchNorm statistics tick) and the
decoder's reconstruction of it, ``gt_x``, is the discriminator's "real".
Stage III trains the decoder and the discriminator under the equilibrium
gate with the cognitive encoder frozen (still in train mode), and ``gt_x``
is the image. Both clamp gradients to +-1.

``backward='spliced'`` (the default) cuts the graph at z and at the
discriminator's image inputs and pulls the cotangents of the two base
losses through each segment with ``torch.autograd.grad``: the
feature-matching B basis (or, where a mode has no B, the pixel NLE) and the
GAN C basis through the discriminator, the decoder head's combination of
them through the decoder, then the B basis back to z and through the
encoder with the KL term. By linearity this gives the naive gradients
(``backward='naive'``: one forward and a full pullback per trained head)
with fewer segment traversals. Frozen groups get no backward pass: the
teacher and the grad-free decodes run under ``torch.no_grad()``. Like the
JAX spliced step, stage-III ``'dcgan'`` pulls only lambda * NLE through the
decoder, where its ``combine_mode`` loss (the naive backward) also has the
GAN term.

With ``pallas_backward`` each conv's weight grad is its own autograd node
(``ops/conv.py::_WeightGrad``), so a pullback that asks for no weight
launches no weight grad, as XLA's DCE prunes that work in the JAX step.

Noise comes from the caller (eps, eps_t, z_p as tensors), so tests inject
the JAX draws. The state is updated in place and returned with the
metrics, which stay on the device under the JAX keys.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.losses.gan_losses import (
    LOG_EPS, combine_mode, equilibrium_gate, vaegan_terms,
)
from fmri_tpu_torch.models.nets import reparameterize
from fmri_tpu_torch.train.common import gate_float
from fmri_tpu_torch.train.optim import RmsProp
from fmri_tpu_torch.train.state import COGNITIVE_TRAINED, GROUPS, TrainState

MODES = ("vae-gan", "vae", "beta-vae", "dcgan")


class StepFns(NamedTuple):
    train_step: Callable
    eval_step: Callable
    generate_step: Callable


def _split_triplet(feats, score, b):
    return (feats[:b], feats[b:2 * b], score[:b], score[b:2 * b], score[2 * b:])


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _check(mode: str, backward: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if backward not in ("spliced", "naive"):
        raise ValueError(f"backward must be 'spliced' or 'naive', got {backward!r}")


def _decode(decoder, zs: List[torch.Tensor], fused: bool) -> List[torch.Tensor]:
    """The decoder over each latent batch of ``zs``, in order: one pass
    each, or one fused pass with ``vsplit=len(zs)`` (the same BatchNorm
    statistics and ticks)."""
    if fused and len(zs) > 1:
        return list(decoder(torch.cat(zs), vsplit=len(zs)).split(zs[0].shape[0]))
    return [decoder(z) for z in zs]


def _cot_c(score: torch.Tensor, b: int, uses_b: bool) -> torch.Tensor:
    """d/d score of the GAN base loss C = sum -log(D(x) + e) +
    sum -log(1 - D(x_p) + e), plus sum -log(1 - D(x_tilde) + e) where the
    mode's discriminator loss has the predicted term."""
    s = score.detach()
    pred = 1.0 / (1.0 - s[b:2 * b] + LOG_EPS) if uses_b else torch.zeros_like(s[b:2 * b])
    return torch.cat([-1.0 / (s[:b] + LOG_EPS), pred, 1.0 / (1.0 - s[2 * b:] + LOG_EPS)])


def _cot_b(feats: torch.Tensor, b: int) -> torch.Tensor:
    """d/d feats of the feature-matching base loss
    B = sum 0.5 * (f_real - f_tilde)^2."""
    d = (feats[:b] - feats[b:2 * b]).detach()
    return torch.cat([d, -d, torch.zeros_like(feats[2 * b:])])


def _named(nets, name: str, grads) -> Dict[str, torch.Tensor]:
    return dict(zip(nets.group(name), grads))


def _encoder_grads(nets, z, mu, lv, gz, k_a: float, gmu=None):
    """The encoder's gradient: gz at z and the KL term A = sum kld, dA/dmu =
    mu, dA/dlogvar = (exp(logvar) - 1) / 2, scaled by ``k_a``; ``gmu``, an
    extra cotangent at mu, joins the same backward."""
    cot_mu = k_a * mu.detach() if gmu is None else k_a * mu.detach() + gmu
    return _named(nets, "encoder", torch.autograd.grad(
        [z, mu, lv], list(nets.group("encoder").values()),
        [gz, cot_mu, k_a * 0.5 * (torch.exp(lv.detach()) - 1.0)]))


def _apply_updates(opt, state: TrainState, grads, lr, gates) -> None:
    for name, g in grads.items():
        opt.update(g, state.opt_state[name], state.nets.group(name), lr, gates[name])


def _metrics(h, b, dec_gate, dis_gate, lr) -> Dict[str, torch.Tensor]:
    return {"loss_encoder": h.encoder.detach() / b,
            "loss_decoder": h.decoder.detach() / b,
            "loss_discriminator": h.discriminator.detach() / b,
            "loss_reconstruction": h.nle_sum.detach() / b,
            "train_dec": dec_gate, "train_dis": dis_gate, "lr": lr}


@torch.no_grad()
def eval_step(state: TrainState, x: torch.Tensor,
              eps: torch.Tensor | None = None) -> torch.Tensor:
    """Eval reconstruction with BatchNorm running statistics
    (``vae_gan.py:288-297``, ``:397-402``): the encoder's input (images for
    stage I, fMRI for II/III) -> z = mu, or mu + eps * exp(logvar / 2) ->
    image."""
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


def _default_lr(cfg: Config, lr_schedule: Callable | None) -> Callable:
    if lr_schedule is not None:
        return lr_schedule
    return lambda step: _scalar(cfg.train.learning_rate, step.device)


def stage1_grads(cfg: Config, mode: str, backward: str) -> Callable:
    """The stage-I forward and backward: ``grads(nets, x, eps, z_p,
    lambda_mse, mu_cot=None) -> (grads, terms, heads)``, with ``grads``
    ``{group: {parameter name: gradient}}`` for the groups ``mode`` trains.
    ``mu_cot(mu)``, where given, is called once on the detached mu after the
    forward and returns an extra cotangent at mu for the encoder's
    gradient (the WAE/Dual-GAN penalty): the spliced backward folds it into
    its one encoder backward, the naive one pulls it back on its own."""
    _check(mode, backward)
    t = cfg.train
    fused = cfg.model.fused_decoder_batch
    uses_b = mode in ("vae-gan", "beta-vae")  # feature matching in enc/dec loss
    trained = GROUPS[1:] if mode == "dcgan" else GROUPS  # dcgan: encoder frozen

    def heads(x, x_tilde, feats, score, mu, lv, lambda_mse):
        b = x.shape[0]
        terms = vaegan_terms(x, x_tilde, *_split_triplet(feats, score, b), mu, lv)
        return terms, combine_mode(terms, mode, lambda_mse=lambda_mse,
                                   beta=t.beta, batch_size=b)

    def encode(nets, x, eps):
        with torch.set_grad_enabled(mode != "dcgan"):
            mu, lv = nets.encoder(x)
            return mu, lv, reparameterize(mu, lv, eps)

    def grads_naive(nets, x, eps, z_p, lambda_mse, mu_cot=None):
        mu, lv, z = encode(nets, x, eps)
        x_tilde, x_p = _decode(nets.decoder, [z, z_p], fused)
        feats, score = nets.discriminator(torch.cat([x, x_tilde, x_p]))
        terms, h = heads(x, x_tilde, feats, score, mu, lv, lambda_mse)
        gmu = mu_cot(mu.detach()) if mu_cot is not None else None
        grads = {}
        for i, name in enumerate(trained):
            params = list(nets.group(name).values())
            grads[name] = _named(nets, name, torch.autograd.grad(
                getattr(h, name), params,
                retain_graph=i < len(trained) - 1 or gmu is not None))
        if gmu is not None and "encoder" in grads:
            params = list(nets.group("encoder").values())
            for k, g in zip(grads["encoder"], torch.autograd.grad(
                    mu, params, gmu, materialize_grads=True)):
                grads["encoder"][k] = grads["encoder"][k] + g
        return grads, terms, h

    def grads_spliced(nets, x, eps, z_p, lambda_mse, mu_cot=None):
        b = x.shape[0]
        dis_p = list(nets.group("discriminator").values())
        mu, lv, z = encode(nets, x, eps)
        gmu = mu_cot(mu.detach()) if mu_cot is not None else None
        z_in = z.detach().requires_grad_()
        x_tilde, x_p = _decode(nets.decoder, [z_in, z_p], fused)
        xt_in = x_tilde.detach().requires_grad_()
        xp_in = x_p.detach().requires_grad_()
        feats, score = nets.discriminator(torch.cat([x, xt_in, xp_in]))
        with torch.no_grad():
            terms, h = heads(x, x_tilde, feats, score, mu, lv, lambda_mse)

        # discriminator: the C basis (its head), to the images where a
        # decoder head uses it ('vae' has no GAN term there)
        imgs = [xt_in, xp_in] if mode != "vae" else []
        g = torch.autograd.grad(score, dis_p + imgs, _cot_c(score, b, uses_b),
                                retain_graph=uses_b)
        grads = {"discriminator": _named(nets, "discriminator", g[:len(dis_p)])}
        gxt_c, gxp_c = g[len(dis_p):] or (None, None)
        lam = lambda_mse
        if uses_b:
            gxt_b, gxp_b = torch.autograd.grad(feats, [xt_in, xp_in], _cot_b(feats, b))
            outs = [x_tilde, x_p]
            cot_dec = [lam * gxt_b - (1.0 - lam) * gxt_c,
                       lam * gxp_b - (1.0 - lam) * gxp_c]
            cot_enc_img = gxt_b
        else:
            cot_nle = x_tilde.detach() - x  # d/d(x_tilde) of sum 0.5 (x - x_tilde)^2
            if mode == "dcgan":
                outs = [x_tilde, x_p]
                cot_dec = [lam * cot_nle - (1.0 - lam) * gxt_c, -(1.0 - lam) * gxp_c]
            else:  # 'vae': L_dec = lam * NLE only
                outs, cot_dec = [x_tilde], [lam * cot_nle]
            cot_enc_img = cot_nle

        # decoder: the head's combination, then the B (or NLE) basis to z
        grads["decoder"] = _named(nets, "decoder", torch.autograd.grad(
            outs, list(nets.group("decoder").values()), cot_dec,
            retain_graph=mode != "dcgan"))
        if mode != "dcgan":
            gz, = torch.autograd.grad(x_tilde, z_in, cot_enc_img)
            k_a = t.beta / b if mode == "beta-vae" else 1.0
            grads["encoder"] = _encoder_grads(nets, z, mu, lv, gz, k_a, gmu)
        return grads, terms, h

    return grads_spliced if backward == "spliced" else grads_naive


def make_vgan_stage1_step(cfg: Config, mode: str = "vae-gan",
                          lr_schedule: Callable | None = None,
                          backward: str = "spliced") -> StepFns:
    """``StepFns(train_step, eval_step, generate_step)`` of the stage-I step.
    ``lr_schedule(step) -> lr`` defaults to the constant
    ``cfg.train.learning_rate``."""
    grads_fn = stage1_grads(cfg, mode, backward)
    t = cfg.train
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=t.grad_clip)
    lr_schedule = _default_lr(cfg, lr_schedule)

    def train_step(state: TrainState, x: torch.Tensor, eps: torch.Tensor,
                   z_p: torch.Tensor, margin, equilibrium, lambda_mse):
        """One step on NHWC images x in [-1, 1] with the reparameterisation
        noise eps and prior draws z_p ([B, latent] each). Returns
        ``(state, metrics)``; the state is the same object, updated."""
        nets = state.nets
        nets.train()
        dev = x.device
        grads, terms, h = grads_fn(nets, x, eps, z_p, _scalar(lambda_mse, dev))
        dec_gate, dis_gate = (gate_float(g) for g in equilibrium_gate(
            terms, _scalar(equilibrium, dev), _scalar(margin, dev),
            init_dis=(mode != "vae")))
        lr = lr_schedule(state.step)
        _apply_updates(opt, state, grads, lr, {"encoder": 1.0, "decoder": dec_gate,
                                               "discriminator": dis_gate})
        state.step += 1
        return state, _metrics(h, x.shape[0], dec_gate, dis_gate, lr)

    return StepFns(train_step, eval_step, generate_step)


def make_vgan_cognitive_step(cfg: Config, stage: int, mode: str = "vae-gan",
                             use_teacher: bool = True,
                             lr_schedule: Callable | None = None,
                             backward: str = "spliced") -> StepFns:
    """``StepFns(train_step, eval_step, generate_step)`` of the stage-II or
    stage-III step on a :class:`~fmri_tpu_torch.train.state.VaeGanCognitiveTrain`
    (with ``teacher_net`` for stage II with ``use_teacher``). Its state
    holds moments for ``COGNITIVE_TRAINED[stage]``
    (:func:`~fmri_tpu_torch.train.state.make_cognitive_state`); RMSprop
    clamps gradients to +-1 whatever ``cfg.train.grad_clip`` says
    (``fmri_tpu/train/stages.py:86,105``)."""
    if stage not in (2, 3):
        raise ValueError(f"stage must be 2 or 3, got {stage!r}")
    _check(mode, backward)
    t = cfg.train
    fused = cfg.model.fused_decoder_batch
    opt = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)
    lr_schedule = _default_lr(cfg, lr_schedule)
    distill = use_teacher and stage == 2
    uses_b = mode in ("vae-gan", "beta-vae")
    spliced = backward == "spliced"
    trained = COGNITIVE_TRAINED[stage]

    def cut(a):  # where the spliced backward cuts the graph
        return a.detach().requires_grad_() if spliced else a

    def forward(nets, fmri, image, eps, eps_t, z_p):
        """The encoder, the decodes and the discriminator. Only the trained
        path keeps a graph: stage II x_tilde back to the encoder, stage III
        x_tilde and x_p back to the decoder's weights. Decoder ticks in the
        JAX step's order: x_tilde, then gt_x (stage II with the teacher),
        then x_p."""
        with torch.set_grad_enabled(stage == 2):
            mu, lv = nets.encoder(fmri)
            z = reparameterize(mu, lv, eps)
        if stage == 2:
            z_in = cut(z)
            x_tilde = nets.decoder(z_in)
            with torch.no_grad():
                if distill:
                    mu_t, lv_t = nets.teacher_net.encoder(image)
                    gt_x, x_p = _decode(nets.decoder, [reparameterize(mu_t, lv_t, eps_t),
                                                       z_p], fused)
                else:
                    gt_x, x_p = image, nets.decoder(z_p)
            xt_in, xp_in = cut(x_tilde), x_p
        else:
            z_in, gt_x = None, image
            x_tilde, x_p = _decode(nets.decoder, [z, z_p], fused)
            xt_in, xp_in = cut(x_tilde), cut(x_p)
        feats, score = nets.discriminator(torch.cat([gt_x, xt_in, xp_in]))
        return dict(mu=mu, lv=lv, z=z, z_in=z_in, gt_x=gt_x, x_tilde=x_tilde,
                    x_p=x_p, xt_in=xt_in, xp_in=xp_in, feats=feats, score=score)

    def heads(f, lambda_mse):
        b = f["gt_x"].shape[0]
        terms = vaegan_terms(f["gt_x"], f["x_tilde"],
                             *_split_triplet(f["feats"], f["score"], b), f["mu"], f["lv"])
        return terms, combine_mode(terms, mode, lambda_mse=lambda_mse,
                                   beta=t.beta, batch_size=b)

    def grads_naive(nets, f, lambda_mse):
        terms, h = heads(f, lambda_mse)
        grads = {}
        for i, name in enumerate(trained):
            params = list(nets.group(name).values())
            grads[name] = _named(nets, name, torch.autograd.grad(
                getattr(h, name), params, retain_graph=i == 0))
        return grads, terms, h

    def grads_spliced(nets, f, lambda_mse):
        with torch.no_grad():
            terms, h = heads(f, lambda_mse)
        b = f["gt_x"].shape[0]
        lam = lambda_mse
        dis_p = list(nets.group("discriminator").values())
        feats, score, x_tilde = f["feats"], f["score"], f["x_tilde"]
        nle = x_tilde.detach() - f["gt_x"]  # d/d(x_tilde) of the NLE sum
        # the discriminator backward runs once per base loss; in stage III
        # the C basis also reaches the images where the decoder head has B
        imgs = [f["xt_in"], f["xp_in"]] if stage == 3 and uses_b else []
        g = torch.autograd.grad(score, dis_p + imgs, _cot_c(score, b, uses_b),
                                retain_graph=uses_b)
        grads = {"discriminator": _named(nets, "discriminator", g[:len(dis_p)])}
        if stage == 2:
            if uses_b:
                cot_xt, = torch.autograd.grad(feats, f["xt_in"], _cot_b(feats, b))
            else:  # 'vae', 'dcgan': L_enc = kld + NLE
                cot_xt = nle
            gz, = torch.autograd.grad(x_tilde, f["z_in"], cot_xt)
            k_a = t.beta / b if mode == "beta-vae" else 1.0
            grads["encoder"] = _encoder_grads(nets, f["z"], f["mu"], f["lv"], gz, k_a)
        else:
            if uses_b:
                gxt_c, gxp_c = g[len(dis_p):]
                gxt_b, gxp_b = torch.autograd.grad(feats, imgs, _cot_b(feats, b))
                outs = [x_tilde, f["x_p"]]
                cot_dec = [lam * gxt_b - (1.0 - lam) * gxt_c,
                           lam * gxp_b - (1.0 - lam) * gxp_c]
            else:  # 'vae' and, as in the JAX spliced step, 'dcgan': lam * NLE
                outs, cot_dec = [x_tilde], [lam * nle]
            grads["decoder"] = _named(nets, "decoder", torch.autograd.grad(
                outs, list(nets.group("decoder").values()), cot_dec))
        return grads, terms, h

    grads_fn = grads_spliced if spliced else grads_naive

    def train_step(state: TrainState, fmri: torch.Tensor, image: torch.Tensor,
                   eps: torch.Tensor, eps_t: torch.Tensor, z_p: torch.Tensor,
                   margin, equilibrium, lambda_mse):
        """One step on fMRI [B, V] and NHWC images in [-1, 1], with the
        reparameterisation noise eps, the teacher's eps_t and the prior
        draws z_p ([B, latent] each). Returns ``(state, metrics)``; the state
        is the same object, updated."""
        nets = state.nets
        nets.train()
        dev = fmri.device
        f = forward(nets, fmri, image, eps, eps_t, z_p)
        grads, terms, h = grads_fn(nets, f, _scalar(lambda_mse, dev))
        if stage == 2:  # encoder and discriminator always train (:557-565)
            dec_gate, dis_gate = _scalar(0.0, dev), _scalar(1.0, dev)
            gates = {"encoder": 1.0, "discriminator": 1.0}
        else:
            dec_gate, dis_gate = (gate_float(g) for g in equilibrium_gate(
                terms, _scalar(equilibrium, dev), _scalar(margin, dev),
                init_dis=(mode != "vae")))
            gates = {"decoder": dec_gate, "discriminator": dis_gate}
        lr = lr_schedule(state.step)
        _apply_updates(opt, state, grads, lr, gates)
        state.step += 1
        return state, _metrics(h, fmri.shape[0], dec_gate, dis_gate, lr)

    return StepFns(train_step, eval_step, generate_step)
