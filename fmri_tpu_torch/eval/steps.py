"""The cognitive VAE/GAN eval module: fMRI -> reconstruction, and decoding
from the prior.

Counterpart of ``make_vgan_cognitive_step``'s ``eval_step``
(``fmri_tpu/train/steps_vgan.py:591-604``) and of ``generate_step``
(``steps_vgan.py:54-63``). Noise comes from the caller (its own
``torch.Generator``), so tests can inject the same draws into both packages.
"""

from __future__ import annotations

import torch
from torch import nn

from fmri_tpu_torch.configs.presets import ModelConfig
from fmri_tpu_torch.models.nets import CognitiveEncoder, Decoder, reparameterize


class VaeGanCognitive(nn.Module):
    """``encoder`` (CognitiveEncoder) + ``decoder`` (Decoder): the
    ``encoder.*``/``decoder.*`` part of the reference's ``VaeGanCognitive``
    state dict (``vae_gan.py:323-432``). Kept in eval mode: BatchNorm uses
    running statistics, so padded rows cannot perturb real ones."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = CognitiveEncoder(cfg)
        self.decoder = Decoder(cfg)
        self.eval()

    @torch.no_grad()
    def reconstruct(self, fmri: torch.Tensor,
                    eps: torch.Tensor | None = None) -> torch.Tensor:
        """[B, V] -> [B, H, W, 3] in [-1, 1]. z = mu, or
        mu + eps * exp(logvar / 2) when ``eps`` is given."""
        mu, logvar = self.encoder(fmri)
        z = mu if eps is None else reparameterize(mu, logvar, eps)
        return self.decoder(z)

    @torch.no_grad()
    def generate(self, z: torch.Tensor) -> torch.Tensor:
        """Decode prior draws z ~ N(0, I) [n, latent] with BatchNorm running
        statistics (the reference's ``model(None)`` branch,
        ``vae_gan.py:294-297``)."""
        return self.decoder(z)
