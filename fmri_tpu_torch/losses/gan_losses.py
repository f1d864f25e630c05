"""Loss algebra of the VAE/GAN and WAE families.

The port's copy of ``fmri_tpu/losses/gan_losses.py:17-154``: the per-example
terms of ``VaeGan.loss`` (reference ``models/vae_gan.py:302-320``), their
per-mode combination (``train_vgan_stage1.py:359-387``), the equilibrium
gate (``:396-404``) as device booleans, so a gated update needs no host
sync, and the WAE latent-discriminator, reconstruction and penalty losses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LOG_EPS = 1e-3  # stabiliser inside the GAN logs (vae_gan.py:316-318)


class VaeGanTerms(NamedTuple):
    """Per-example loss terms (each [B] except nle [B, D])."""

    nle: torch.Tensor                # 0.5 * (x - x_tilde)^2, flattened
    kld: torch.Tensor                # KL(q(z|x) || N(0, I)) per example
    mse: torch.Tensor                # 0.5 * feature-matching squared error
    bce_dis_original: torch.Tensor   # -log(D(x) + eps)
    bce_dis_predicted: torch.Tensor  # -log(1 - D(x_tilde) + eps)
    bce_dis_sampled: torch.Tensor    # -log(1 - D(x_p) + eps)


def vaegan_terms(x, x_tilde, disc_layer_original, disc_layer_predicted,
                 disc_class_original, disc_class_predicted, disc_class_sampled,
                 mus, logvars) -> VaeGanTerms:
    b = x.shape[0]
    nle = 0.5 * (x.reshape(b, -1) - x_tilde.reshape(b, -1)) ** 2
    kld = -0.5 * torch.sum(-torch.exp(logvars) - mus**2 + logvars + 1.0, dim=1)
    mse = torch.sum(0.5 * (disc_layer_original - disc_layer_predicted) ** 2, dim=1)
    bce_orig = -torch.log(disc_class_original + LOG_EPS)
    bce_pred = -torch.log(1.0 - disc_class_predicted + LOG_EPS)
    bce_samp = -torch.log(1.0 - disc_class_sampled + LOG_EPS)
    return VaeGanTerms(nle, kld, mse, bce_orig.reshape(-1), bce_pred.reshape(-1),
                       bce_samp.reshape(-1))


class HeadLosses(NamedTuple):
    """Scalar losses of the three optimizer groups plus the logged recon sum."""

    encoder: torch.Tensor
    decoder: torch.Tensor
    discriminator: torch.Tensor
    nle_sum: torch.Tensor


def combine_mode(terms: VaeGanTerms, mode: str, *, lambda_mse,
                 beta: float = 1.0, batch_size: int | None = None) -> HeadLosses:
    """Per-mode loss combination; ``mode`` is 'vae-gan', 'beta-vae',
    'dcgan' or 'vae'."""
    s = torch.sum
    nle_sum = s(terms.nle)
    if mode in ("vae-gan", "beta-vae"):
        kld = s(terms.kld)
        if mode == "beta-vae":
            kld = kld * beta * (1.0 / batch_size)
        loss_enc = kld + s(terms.mse)
        loss_dis = (s(terms.bce_dis_original) + s(terms.bce_dis_predicted)
                    + s(terms.bce_dis_sampled))
        loss_dec = s(lambda_mse * terms.mse) - (1.0 - lambda_mse) * loss_dis
    elif mode == "dcgan":
        loss_enc = s(terms.kld) + nle_sum
        loss_dis = s(terms.bce_dis_original) + s(terms.bce_dis_sampled)
        loss_dec = s(lambda_mse * terms.nle) - (1.0 - lambda_mse) * loss_dis
    elif mode == "vae":
        loss_enc = s(terms.kld) + nle_sum
        loss_dis = s(terms.bce_dis_original) + s(terms.bce_dis_sampled)
        loss_dec = s(lambda_mse * terms.nle)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return HeadLosses(loss_enc, loss_dec, loss_dis, nle_sum)


def equilibrium_gate(terms: VaeGanTerms, equilibrium, margin,
                     init_dec: bool = True, init_dis: bool = True, means=None):
    """``(train_dec, train_dis)`` as device booleans: skip D if the mean
    bce_orig or bce_pred is below ``equilibrium - margin``, skip G if either
    is above ``equilibrium + margin``, train both if both end up skipped.
    ``init_dec``/``init_dis`` are the mode's pre-gate defaults ('vae' sets
    ``train_dis = False`` before the gate, which the both-off rule can
    override). ``means``, where given, replaces the batch's ``(mean
    bce_orig, mean bce_pred)``: a step on a mesh passes the global batch's,
    since a rank that gated on its own rows could update while another
    skips, and the replicas would part."""
    m_orig, m_pred = means if means is not None else (
        torch.mean(terms.bce_dis_original), torch.mean(terms.bce_dis_predicted))
    dis_low = (m_orig < equilibrium - margin) | (m_pred < equilibrium - margin)
    dec_high = (m_orig > equilibrium + margin) | (m_pred > equilibrium + margin)
    train_dis = ~dis_low & init_dis
    train_dec = ~dec_high & init_dec
    both_off = ~train_dis & ~train_dec
    return train_dec | both_off, train_dis | both_off


# --------------------------- WAE family ---------------------------


def wae_disc_losses(d_real: torch.Tensor, d_fake: torch.Tensor, lam: float = 10.0):
    """The latent discriminator's two terms (``train_wae_stage1.py:281-282``):
    ``L_fake = -lam * sum(log(d_fake + eps))``, ``L_real = -lam *
    sum(log(1 - d_real + eps))``. Stage I scores prior draws as fake and
    encoder latents as real; stages II/III score cognitive latents as fake
    and teacher latents as real (``train_wae_stage2.py:292-307``)."""
    loss_fake = -lam * torch.sum(torch.log(d_fake + LOG_EPS))
    loss_real = -lam * torch.sum(torch.log(1.0 - d_real + LOG_EPS))
    return loss_fake, loss_real


def wae_recon_sum(x_recon: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Stage-I recon loss ``sum(0.5 * (x_recon - x)^2)``
    (``train_wae_stage1.py:301``)."""
    return torch.sum(0.5 * (x_recon - x) ** 2)


def wae_recon_mean(x_recon: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Stage-II/III recon loss, ``nn.MSELoss`` with mean reduction
    (``train_wae_stage2.py:320-321``)."""
    return torch.mean((x_recon - x) ** 2)


def wae_penalty_sum(d_real: torch.Tensor, lam: float = 10.0) -> torch.Tensor:
    """Stage-I adversarial penalty ``-lam * sum(log(d_real + eps))``
    (``train_wae_stage1.py:303``)."""
    return -lam * torch.sum(torch.log(d_real + LOG_EPS))


def wae_penalty_mean(d_real: torch.Tensor, lam: float = 10.0) -> torch.Tensor:
    """Stage-II penalty ``-lam * mean(log(d_real + eps))``
    (``train_wae_stage2.py:322``)."""
    return -lam * torch.mean(torch.log(d_real + LOG_EPS))
