"""Plain PyTorch reference of the WAE/GAN stage I of
github.com/MariaPdg/thesis-fmri-reconstruction (``models/vae_gan.py:435-529``,
``WaeGan`` and ``WaeDiscriminator``; ``train/train_wae_stage1.py:221-311``;
``configs/wae_config.py``): a Wasserstein auto-encoder with an adversary in
latent space (Tolstikhin et al., arXiv:1711.01558, WAE-GAN), trained as the
thesis's loop trains it.

The encoder, the decoder, BatchNorm, the input half and the precisions are
``reference/vaegan.py``'s; this file adds the latent discriminator, its
losses, Adam as ``torch.optim.Adam`` computes it, StepLR per epoch and the
literal two-phase step. It imports nothing of the program under test.

A step, as ``train_wae_stage1.py`` runs it:

1. The encoder and decoder frozen: the encoder in train mode without a
   gradient gives z_real = mu (its BatchNorm's running statistics tick); the
   latent discriminator D scores z_real and z_fake ~ N(0, sigma^2),
   L_fake = -lam * sum log(D(z_fake) + 1e-3), L_real = -lam * sum log(1 -
   D(z_real) + 1e-3); D takes one Adam step at 0.5 x lr.
2. D frozen: the encoder runs again (a second tick on the same batch), mu is
   decoded (no reparameterisation), and the encoder and decoder take one
   Adam step on sum 0.5 (x_rec - x)^2 - lam * sum log(D(mu) + 1e-3), the
   penalty against the *updated* D.

Departures from the thesis: images arrive as uint8 and are flipped and
normalized by ``vaegan.augment`` (the thesis's torchvision transforms give
the same values); z_fake is drawn by the caller (the thesis draws it with
``torch.randn`` inside the loop); the running statistics are kept in the
weights dict, ticked as ``nn.BatchNorm`` ticks them (momentum 0.9 as the new
batch's weight, the unbiased variance), from the batch statistics that
``vaegan.batch_norm`` records; ``num_batches_tracked`` is not kept.
``fault`` computes a deliberately wrong step, for the checks that the
comparison refuses it: ``"one_tick"`` ticks the encoder's statistics once a
step, ``"stale_disc"`` takes the penalty against D as it was before phase 1,
``"disc_lr"`` steps D at the full lr.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from portbench.reference.vaegan import (
    LOG_EPS, Precision, augment, decoder, decoder_spec, exact_fp32, is_parameter,
    visual_encoder, visual_encoder_spec,
)

BN_MOMENTUM = 0.9  # the new batch's weight (vae_gan.py's nn.BatchNorm*(momentum=0.9))
GROUPS = ("encoder", "decoder", "discriminator")
FAULTS = ("", "one_tick", "stale_disc", "disc_lr")


def latent_disc_spec(m: dict, p: str = "discriminator.") -> List[Tuple[str, tuple, str]]:
    """``WaeDiscriminator.main`` (vae_gan.py:499-529): 4 x [Linear(h) + ReLU],
    Linear(1), sigmoid, keyed ``main.{0,2,4,6,8}``."""
    h, out = m["wae_disc_hidden"], []
    for i, (cin, cout) in enumerate([(m["latent_dim"], h), (h, h), (h, h), (h, h), (h, 1)]):
        out += [(f"{p}main.{2 * i}.weight", (cout, cin), "linear"),
                (f"{p}main.{2 * i}.bias", (cout,), "bias")]
    return out


def specs(m: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, kind) of every tensor of ``WaeGan``'s state dict."""
    return visual_encoder_spec(m) + decoder_spec(m) + latent_disc_spec(m)


def latent_disc(w, z, P: Precision, p: str = "discriminator."):
    """Latent [B, latent] -> score [B, 1]."""
    for i in range(0, 10, 2):
        z = P.linear(z, w[f"{p}main.{i}.weight"], w[f"{p}main.{i}.bias"])
        z = torch.relu(z) if i < 8 else torch.sigmoid(z)
    return z


def wae_disc_losses(d_real, d_fake, lam: float):
    """(L_fake, L_real) of phase 1 (train_wae_stage1.py:281-282)."""
    return (-lam * torch.sum(torch.log(d_fake + LOG_EPS)),
            -lam * torch.sum(torch.log(1.0 - d_real + LOG_EPS)))


def wae_gen_losses(x, x_rec, d_mu, lam: float):
    """(reconstruction, penalty) of phase 2 (train_wae_stage1.py:301-303)."""
    return (torch.sum(0.5 * (x_rec - x) ** 2),
            -lam * torch.sum(torch.log(d_mu + LOG_EPS)))


def _rows(m: dict, b: int, p: str) -> int:
    """Elements each BatchNorm of ``visual_encoder`` or ``decoder`` reduces
    over per channel, at ``b`` rows, by its key prefix."""
    k, s, pad = m["kernel_size"], m["stride"], m["padding"]
    if p.endswith("fc.1."):
        return b
    i = int(p.split(".")[-3])
    if p.startswith("encoder."):
        h = m["image_size"]
        for _ in range(i + 1):
            h = (h + 2 * pad - k) // s + 1
        return b * h * h
    h = m["fc_input"]
    for j in range(i + 1):
        h = (h - 1) * s - 2 * pad + k + (1 if m["output_pad_dec"][j] else 0)
    return b * h * h


@torch.no_grad()
def _tick(w, record: Dict[str, tuple], m: dict, b: int) -> None:
    """One ``nn.BatchNorm`` tick of every running statistic in ``record``."""
    for p, (mean, var) in record.items():
        n = _rows(m, b, p)
        for key, v in ((p + "running_mean", mean), (p + "running_var", var * n / (n - 1))):
            w[key] = (1.0 - BN_MOMENTUM) * w[key] + BN_MOMENTUM * v.detach()


def _ticked(w, net, z, m, P, ticks: int):
    """``net(w, z, m, P)`` in train mode; its BatchNorms' running statistics
    tick ``ticks`` times on this batch's statistics."""
    w["_record"] = {}
    y = net(w, z, m, P)
    record = w.pop("_record")
    for _ in range(ticks):
        _tick(w, record, m, z.shape[0])
    return y


def _mu(w, x, m, P):
    return visual_encoder(w, x, m, P)[0]


def running_stats(w, prefix: str) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in w.items()
            if k.startswith(prefix) and k.endswith(("running_mean", "running_var"))}


def train_steps(w0: Dict[str, torch.Tensor], steps, m: dict, t: dict, P: Precision,
                steps_per_epoch: Optional[int] = None, fault: str = "") -> dict:
    """Run ``len(steps)`` WAE/GAN stage-I steps from the weights ``w0`` (every
    key of :func:`specs`) and fresh optimizers: Adam(``adam_b1``,
    ``adam_b2``) at ``learning_rate`` for the encoder and decoder and at half
    of it for the discriminator, each under StepLR(``step_size``,
    ``step_gamma``) stepped at every epoch's end (``steps_per_epoch``: None,
    never). ``steps`` holds each step's ``x`` (uint8 NHWC), ``flip`` and
    ``z_fake`` (already scaled by sigma). Returns ``{"losses": [{head: loss
    over the rows}] per step, "grad1": {key: |g|} of each trained leaf's
    first gradient, "grad1_rec": {key: |g_rec|} of the reconstruction's
    part of it (the encoder's and decoder's leaves), "change": {key: |w -
    w0|} after the last step,
    "running": [{key: tensor}] of the encoder's running statistics after
    each step, "weights": the last weights, "moments": {key: (exp_avg,
    exp_avg_sq)}}``."""
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    exact_fp32()
    keys = {g: [k for k, _, kind in specs(m) if is_parameter(kind) and k.startswith(g + ".")]
            for g in GROUPS}
    w = {k: v.clone() for k, v in w0.items()}
    live = {k: w[k].requires_grad_() for g in GROUPS for k in keys[g]}
    betas, lr, lam = (t["adam_b1"], t["adam_b2"]), t["learning_rate"], t["wae_lambda"]
    gen_opt = torch.optim.Adam([live[k] for k in keys["encoder"] + keys["decoder"]], lr=lr,
                               betas=betas)
    dis_opt = torch.optim.Adam([live[k] for k in keys["discriminator"]],
                               lr=(1.0 if fault == "disc_lr" else 0.5) * lr, betas=betas)
    scheds = [torch.optim.lr_scheduler.StepLR(o, t["step_size"], t["step_gamma"])
              for o in (gen_opt, dis_opt)]
    ticks = 1 if fault == "one_tick" else 2
    out = {"losses": [], "grad1": {}, "grad1_rec": {}, "change": {}, "running": []}
    for i, s in enumerate(steps):
        x = augment(s["x"], s.get("flip"))
        b = x.shape[0]
        # phase 1: the latent D on detached latents
        with torch.no_grad():
            z_real = _ticked(w, _mu, x, m, P, 1)
        stale = ({k: w[k].detach().clone() for k in keys["discriminator"]}
                 if fault == "stale_disc" else {})
        loss_fake, loss_real = wae_disc_losses(latent_disc(w, z_real, P),
                                               latent_disc(w, s["z_fake"], P), lam)
        g_dis = torch.autograd.grad(loss_fake + loss_real,
                                    [live[k] for k in keys["discriminator"]])
        for k, g in zip(keys["discriminator"], g_dis):
            live[k].grad = g
        dis_opt.step()
        # phase 2: encoder and decoder against the updated D
        mu = _ticked(w, _mu, x, m, P, ticks - 1)
        x_rec = _ticked(w, decoder, mu, m, P, 1)
        loss_rec, loss_pen = wae_gen_losses(x, x_rec, latent_disc(dict(w, **stale), mu, P),
                                            lam)
        gen = keys["encoder"] + keys["decoder"]
        if i == 0:
            g_rec = torch.autograd.grad(loss_rec, [live[k] for k in gen], retain_graph=True,
                                        materialize_grads=True)
            out["grad1_rec"] = {k: float(torch.linalg.vector_norm(g)) for k, g in zip(gen, g_rec)}
        g_gen = torch.autograd.grad(loss_rec + loss_pen, [live[k] for k in gen],
                                    materialize_grads=True)
        for k, g in zip(gen, g_gen):
            live[k].grad = g
        gen_opt.step()
        if i == 0:
            out["grad1"] = {k: float(torch.linalg.vector_norm(g))
                            for k, g in zip(keys["discriminator"] + gen, g_dis + g_gen)}
        if steps_per_epoch and (i + 1) % steps_per_epoch == 0:
            for sc in scheds:
                sc.step()
        out["losses"].append({"reconstruction": float(loss_rec.detach()) / b,
                              "penalty": float(loss_pen.detach()) / b,
                              "discriminator_fake": float(loss_fake.detach()) / b,
                              "discriminator_real": float(loss_real.detach()) / b})
        out["running"].append(running_stats(w, "encoder."))
    trained = [k for g in GROUPS for k in keys[g]]
    out["change"] = {k: float(torch.linalg.vector_norm(w[k].detach() - w0[k])) for k in trained}
    states = {**gen_opt.state, **dis_opt.state}
    out["moments"] = {k: (states[live[k]]["exp_avg"], states[live[k]]["exp_avg_sq"])
                      for k in trained if live[k] in states}
    out["weights"] = {k: v.detach() for k, v in w.items()}
    return out
