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

``mesh`` (``parallel/mesh.py``): the step runs on this rank's rows of the
global batch, with a state placed on the same mesh
(``parallel.mesh.shard_state``). Its BatchNorms take the global batch's
statistics; the losses are batch sums, so each rank's pullback is its part
of the global loss, and every trained group's gradient is summed over the
data group after the last ``torch.autograd.grad``, before the optimizer;
the gate and the metrics take the global batch's means. RMSprop's clamp is
elementwise and needs no global norm. With a model axis the step runs
cuDNN's deterministic algorithms (``_on_mesh``).

Under a profiler the steps mark their phases (``utils/spans.py``):
``train.step`` (``_on_mesh``, so every family's step), ``train.forward``
(through the head losses), ``train.backward`` (the spliced backward's
segments ``train.backward.discriminator``, ``.decoder``, ``.encoder``),
``train.gate`` (the gradients' reduction, the head sums, the gate, the
learning rate) and ``train.optimizer`` (``train.optimizer.<group>``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.device import deterministic_cudnn
from fmri_tpu_torch.losses.gan_losses import (
    LOG_EPS, combine_mode, equilibrium_gate, vaegan_terms,
)
from fmri_tpu_torch.models.nets import reparameterize
from fmri_tpu_torch.train.common import gate_float
from fmri_tpu_torch.train.optim import RmsProp
from fmri_tpu_torch.train.state import COGNITIVE_TRAINED, GROUPS, TrainState
from fmri_tpu_torch.utils.spans import span

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
    mode's discriminator loss has the predicted term. ``b`` is this rank's
    rows (the local third of the 3b concat), under a mesh too."""
    s = score.detach()
    pred = 1.0 / (1.0 - s[b:2 * b] + LOG_EPS) if uses_b else torch.zeros_like(s[b:2 * b])
    return torch.cat([-1.0 / (s[:b] + LOG_EPS), pred, 1.0 / (1.0 - s[2 * b:] + LOG_EPS)])


def _cot_b(feats: torch.Tensor, b: int) -> torch.Tensor:
    """d/d feats of the feature-matching base loss
    B = sum 0.5 * (f_real - f_tilde)^2; ``b`` local, as in :func:`_cot_c`."""
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
    with span("train.optimizer"):
        for name, g in grads.items():
            with span("train.optimizer." + name):
                opt.update(g, state.opt_state[name], state.nets.group(name), lr, gates[name])


def _data(mesh) -> int:
    """The data axis's size (1 without a mesh)."""
    return 1 if mesh is None else mesh.data


def _on_mesh(train_step: Callable, mesh) -> Callable:
    """``train_step`` checking that its state sits on the step's ``mesh``
    (None: not placed). With a model axis over 1 it runs cuDNN's
    deterministic algorithms: the model group's ranks compute the
    replicated layers redundantly, and stay bitwise equal only if each
    computes them alike (the ``Trainer`` runs them always)."""
    tp = mesh is not None and mesh.model > 1

    def step(state: TrainState, *args):
        if state.mesh is not mesh:
            raise ValueError(f"the step was made for {mesh} and the state is placed on "
                             f"{state.mesh}: place it with parallel.mesh.shard_state(state, "
                             f"mesh) and make the step with the same mesh")
        with span("train.step"):
            if not tp:
                return train_step(state, *args)
            with deterministic_cudnn():
                return train_step(state, *args)

    return step


def _data_sums(mesh, *values: torch.Tensor):
    """``values`` (detached scalars) summed over the data group: the
    global batch's sums."""
    values = tuple(v.detach() for v in values)
    if _data(mesh) == 1:
        return values
    return tuple(mesh.data_sum(torch.stack(values)).unbind(0))


def _step_sums(mesh, bce_orig: torch.Tensor, bce_pred: torch.Tensor,
               *values: torch.Tensor):
    """``((mean bce_orig, mean bce_pred), values)``: the equilibrium gate's
    two means over the global batch and ``values`` (detached scalars)
    summed over the data group, from one all-reduce per step."""
    o, p = bce_orig.detach(), bce_pred.detach()
    if _data(mesh) == 1:
        return (torch.mean(o), torch.mean(p)), tuple(v.detach() for v in values)
    sums = mesh.data_sum(torch.stack([o.sum(), p.sum(), *(v.detach() for v in values)]))
    n = o.numel() * mesh.data
    return (sums[0] / n, sums[1] / n), tuple(sums[2:].unbind(0))


def _head_sums(mesh, terms, h, *values: torch.Tensor):
    """:func:`_step_sums` of a VAE/GAN step: the gate's means, the four
    head losses' global sums (for :func:`_metrics`), then ``values``'."""
    return _step_sums(mesh, terms.bce_dis_original, terms.bce_dis_predicted,
                      h.encoder, h.decoder, h.discriminator, h.nle_sum, *values)


def _reduce_grads(grads, mesh):
    """The gradients summed over the data group (unchanged without a mesh)."""
    return grads if mesh is None else mesh.sum_grads(grads)


def _metrics(sums, n, dec_gate, dis_gate, lr) -> Dict[str, torch.Tensor]:
    """The JAX keys: the four head losses' global sums (:func:`_head_sums`)
    over the global batch's size ``n``."""
    enc, dec, dis, nle = sums[:4]
    return {"loss_encoder": enc / n, "loss_decoder": dec / n,
            "loss_discriminator": dis / n, "loss_reconstruction": nle / n,
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


def stage1_grads(cfg: Config, mode: str, backward: str, data: int = 1) -> Callable:
    """The stage-I forward and backward: ``grads(nets, x, eps, z_p,
    lambda_mse, mu_cot=None) -> (grads, terms, heads)``, with ``grads``
    ``{group: {parameter name: gradient}}`` for the groups ``mode`` trains
    (this rank's part; ``data`` ranks share the global batch, whose size
    scales 'beta-vae''s KL term).
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
                                   beta=t.beta, batch_size=b * data)

    def encode(nets, x, eps):
        with torch.set_grad_enabled(mode != "dcgan"):
            mu, lv = nets.encoder(x)
            return mu, lv, reparameterize(mu, lv, eps)

    def grads_naive(nets, x, eps, z_p, lambda_mse, mu_cot=None):
        with span("train.forward"):
            mu, lv, z = encode(nets, x, eps)
            x_tilde, x_p = _decode(nets.decoder, [z, z_p], fused)
            feats, score = nets.discriminator(torch.cat([x, x_tilde, x_p]))
            terms, h = heads(x, x_tilde, feats, score, mu, lv, lambda_mse)
            gmu = mu_cot(mu.detach()) if mu_cot is not None else None
        with span("train.backward"):
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
        with span("train.forward"):
            mu, lv, z = encode(nets, x, eps)
            gmu = mu_cot(mu.detach()) if mu_cot is not None else None
            z_in = z.detach().requires_grad_()
            x_tilde, x_p = _decode(nets.decoder, [z_in, z_p], fused)
            xt_in = x_tilde.detach().requires_grad_()
            xp_in = x_p.detach().requires_grad_()
            feats, score = nets.discriminator(torch.cat([x, xt_in, xp_in]))
            with torch.no_grad():
                terms, h = heads(x, x_tilde, feats, score, mu, lv, lambda_mse)

        with span("train.backward"):
            # discriminator: the C basis (its head), to the images where a
            # decoder head uses it ('vae' has no GAN term there); the B
            # basis to the images
            imgs = [xt_in, xp_in] if mode != "vae" else []
            with span("train.backward.discriminator"):
                g = torch.autograd.grad(score, dis_p + imgs, _cot_c(score, b, uses_b),
                                        retain_graph=uses_b)
                grads = {"discriminator": _named(nets, "discriminator", g[:len(dis_p)])}
                gxt_c, gxp_c = g[len(dis_p):] or (None, None)
                if uses_b:
                    gxt_b, gxp_b = torch.autograd.grad(feats, [xt_in, xp_in],
                                                       _cot_b(feats, b))
            lam = lambda_mse
            if uses_b:
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
            with span("train.backward.decoder"):
                grads["decoder"] = _named(nets, "decoder", torch.autograd.grad(
                    outs, list(nets.group("decoder").values()), cot_dec,
                    retain_graph=mode != "dcgan"))
                if mode != "dcgan":
                    gz, = torch.autograd.grad(x_tilde, z_in, cot_enc_img)
            if mode != "dcgan":
                k_a = t.beta / (b * data) if mode == "beta-vae" else 1.0
                with span("train.backward.encoder"):
                    grads["encoder"] = _encoder_grads(nets, z, mu, lv, gz, k_a, gmu)
        return grads, terms, h

    return grads_spliced if backward == "spliced" else grads_naive


def make_vgan_stage1_step(cfg: Config, mode: str = "vae-gan",
                          lr_schedule: Callable | None = None,
                          backward: str = "spliced", mesh=None) -> StepFns:
    """``StepFns(train_step, eval_step, generate_step)`` of the stage-I step.
    ``lr_schedule(step) -> lr`` defaults to the constant
    ``cfg.train.learning_rate``."""
    grads_fn = stage1_grads(cfg, mode, backward, _data(mesh))
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
        with span("train.gate"):
            grads = _reduce_grads(grads, mesh)
            means, sums = _head_sums(mesh, terms, h)
            dec_gate, dis_gate = (gate_float(g) for g in equilibrium_gate(
                terms, _scalar(equilibrium, dev), _scalar(margin, dev),
                init_dis=(mode != "vae"), means=means))
            lr = lr_schedule(state.step)
        _apply_updates(opt, state, grads, lr, {"encoder": 1.0, "decoder": dec_gate,
                                               "discriminator": dis_gate})
        state.step += 1
        return state, _metrics(sums, x.shape[0] * _data(mesh), dec_gate, dis_gate, lr)

    return StepFns(_on_mesh(train_step, mesh), eval_step, generate_step)


def make_vgan_cognitive_step(cfg: Config, stage: int, mode: str = "vae-gan",
                             use_teacher: bool = True,
                             lr_schedule: Callable | None = None,
                             backward: str = "spliced", mesh=None) -> StepFns:
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
    data = _data(mesh)

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
                                   beta=t.beta, batch_size=b * data)

    def grads_naive(nets, f, h, lambda_mse):
        grads = {}
        for i, name in enumerate(trained):
            params = list(nets.group(name).values())
            grads[name] = _named(nets, name, torch.autograd.grad(
                getattr(h, name), params, retain_graph=i == 0))
        return grads

    def grads_spliced(nets, f, h, lambda_mse):
        b = f["gt_x"].shape[0]
        lam = lambda_mse
        dis_p = list(nets.group("discriminator").values())
        feats, score, x_tilde = f["feats"], f["score"], f["x_tilde"]
        nle = x_tilde.detach() - f["gt_x"]  # d/d(x_tilde) of the NLE sum
        # the discriminator backward runs once per base loss; in stage III
        # the C basis also reaches the images where the decoder head has B
        imgs = [f["xt_in"], f["xp_in"]] if stage == 3 and uses_b else []
        with span("train.backward.discriminator"):
            g = torch.autograd.grad(score, dis_p + imgs, _cot_c(score, b, uses_b),
                                    retain_graph=uses_b)
            grads = {"discriminator": _named(nets, "discriminator", g[:len(dis_p)])}
            if uses_b:  # the B basis to the images
                cot_b = torch.autograd.grad(feats, f["xt_in"] if stage == 2 else imgs,
                                            _cot_b(feats, b))
        if stage == 2:
            cot_xt = cot_b[0] if uses_b else nle  # 'vae', 'dcgan': L_enc = kld + NLE
            with span("train.backward.decoder"):
                gz, = torch.autograd.grad(x_tilde, f["z_in"], cot_xt)
            k_a = t.beta / (b * data) if mode == "beta-vae" else 1.0
            with span("train.backward.encoder"):
                grads["encoder"] = _encoder_grads(nets, f["z"], f["mu"], f["lv"], gz, k_a)
        else:
            if uses_b:
                gxt_c, gxp_c = g[len(dis_p):]
                gxt_b, gxp_b = cot_b
                outs = [x_tilde, f["x_p"]]
                cot_dec = [lam * gxt_b - (1.0 - lam) * gxt_c,
                           lam * gxp_b - (1.0 - lam) * gxp_c]
            else:  # 'vae' and, as in the JAX spliced step, 'dcgan': lam * NLE
                outs, cot_dec = [x_tilde], [lam * nle]
            with span("train.backward.decoder"):
                grads["decoder"] = _named(nets, "decoder", torch.autograd.grad(
                    outs, list(nets.group("decoder").values()), cot_dec))
        return grads

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
        with span("train.forward"):
            f = forward(nets, fmri, image, eps, eps_t, z_p)
            lam = _scalar(lambda_mse, dev)
            if spliced:  # the spliced backward needs no graph of the heads
                with torch.no_grad():
                    terms, h = heads(f, lam)
            else:
                terms, h = heads(f, lam)
        with span("train.backward"):
            grads = grads_fn(nets, f, h, lam)
        with span("train.gate"):
            grads = _reduce_grads(grads, mesh)
            means, sums = _head_sums(mesh, terms, h)
            if stage == 2:  # encoder and discriminator always train (:557-565)
                dec_gate = torch.zeros((), dtype=torch.float32, device=dev)
                dis_gate = torch.ones((), dtype=torch.float32, device=dev)
                gates = {"encoder": 1.0, "discriminator": 1.0}
            else:
                dec_gate, dis_gate = (gate_float(g) for g in equilibrium_gate(
                    terms, _scalar(equilibrium, dev), _scalar(margin, dev),
                    init_dis=(mode != "vae"), means=means))
                gates = {"decoder": dec_gate, "discriminator": dis_gate}
            lr = lr_schedule(state.step)
        _apply_updates(opt, state, grads, lr, gates)
        state.step += 1
        return state, _metrics(sums, fmri.shape[0] * data, dec_gate, dis_gate, lr)

    return StepFns(_on_mesh(train_step, mesh), eval_step, generate_step)
