"""The cognitive VAE/GAN networks used at inference: ``CognitiveEncoder``
(fMRI voxels -> mu, logvar) and ``Decoder`` (latent -> image).

Counterparts of ``fmri_tpu/models/nets.py`` (``DecoderBlock`` :95,
``CognitiveEncoder`` :153, ``Decoder`` :177, ``reparameterize`` :424). The
attribute names are the reference's torch ones (``fc1.0/.1``, ``l_mu``,
``l_var``, ``fc.0/.1``, ``conv.{0,1,2}.conv/.bn``, ``conv.3.0``), so its
state dicts load with ``strict=True``.

BatchNorm: eps 1e-5. The reference's torch ``momentum`` is 0.9 (new-batch
weight: running = 0.1 * running + 0.9 * batch), not torch's default 0.1; the
JAX package writes the same EMA as flax momentum 0.1 (``nets.py:33-36``).
This slice runs BatchNorm in eval mode only (running statistics); the
training slice must keep momentum=0.9.

Modules compute in NCHW. ``Decoder`` returns NHWC, the public image layout.
"""

from __future__ import annotations

import torch
from torch import nn

from fmri_tpu_torch.configs.presets import ModelConfig
from fmri_tpu_torch.ops.conv import conv2d, conv2d_transpose, linear

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def _cd(cfg: ModelConfig) -> str | None:
    return None if cfg.compute_dtype in (None, "float32") else cfg.compute_dtype


class DecoderBlock(nn.Module):
    """ConvTranspose(k5, s2, p2, no bias, output_padding) + BN + ReLU
    (reference ``vae_gan.py:38-60``)."""

    def __init__(self, cin: int, cout: int, output_pad: bool, cfg: ModelConfig):
        super().__init__()
        self.stride, self.padding = cfg.stride, cfg.padding
        self.output_padding = 1 if output_pad else 0
        self.compute_dtype = _cd(cfg)
        self.conv = nn.ConvTranspose2d(
            cin, cout, cfg.kernel_size, cfg.stride, cfg.padding,
            output_padding=self.output_padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_transpose(x, self.conv.weight, self.stride, self.padding,
                             self.output_padding, self.compute_dtype)
        return torch.relu(self.bn(y))


class CognitiveEncoder(nn.Module):
    """fMRI voxels [B, V] -> (mu, logvar) [B, latent]
    (reference ``vae_gan.py:190-232``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.compute_dtype = _cd(cfg)
        self.fc1 = nn.Sequential(
            nn.Linear(cfg.num_voxels, cfg.cog_hidden, bias=False),
            nn.BatchNorm1d(cfg.cog_hidden, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU())
        self.l_mu = nn.Linear(cfg.cog_hidden, cfg.latent_dim)
        self.l_var = nn.Linear(cfg.cog_hidden, cfg.latent_dim)

    def forward(self, v: torch.Tensor):
        cd = self.compute_dtype
        x = linear(v, self.fc1[0].weight, None, cd)
        x = torch.relu(self.fc1[1](x))
        mu = linear(x, self.l_mu.weight, self.l_mu.bias, cd)
        logvar = linear(x, self.l_var.weight, self.l_var.bias, cd)
        return mu, logvar


class Decoder(nn.Module):
    """Latent [B, latent] -> image [B, H, W, 3] in [-1, 1]
    (reference ``vae_gan.py:99-132``): FC + BN + ReLU, three deconv blocks,
    5x5 out-conv + bias, tanh."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.compute_dtype = _cd(cfg)
        self.size0, self.fc_input = cfg.encoder_channels[-1], cfg.fc_input
        flat = self.fc_input * self.fc_input * self.size0
        self.fc = nn.Sequential(
            nn.Linear(cfg.latent_dim, flat, bias=False),
            nn.BatchNorm1d(flat, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU())
        chans = (self.size0, self.size0, cfg.decoder_channels[1],
                 cfg.decoder_channels[2])
        blocks = [DecoderBlock(chans[i], chans[i + 1], cfg.output_pad_dec[i], cfg)
                  for i in range(3)]
        out = nn.Sequential(
            nn.Conv2d(chans[3], cfg.decoder_channels[3], 5, 1, 2), nn.Tanh())
        self.conv = nn.Sequential(*blocks, out)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = linear(z, self.fc[0].weight, None, cd)
        x = torch.relu(self.fc[1](x))
        # C-major flatten, as the reference's view(B, C, H, W)
        x = x.view(x.shape[0], self.size0, self.fc_input, self.fc_input)
        for blk in self.conv[:3]:
            x = blk(x)
        out = self.conv[3][0]
        x = conv2d(x, out.weight, 1, 2, cd) + out.bias.view(1, -1, 1, 1)
        return torch.tanh(x).permute(0, 2, 3, 1).contiguous()


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(logvar / 2); ``eps`` comes from the caller's
    generator (``nets.py:424-427``)."""
    return mu + eps * torch.exp(0.5 * logvar)
