"""The VAE/GAN networks: ``VisualEncoder`` (image -> mu, logvar),
``CognitiveEncoder`` (fMRI voxels -> mu, logvar), ``Decoder`` (latent ->
image) and ``ImageDiscriminator`` (image -> feature tap, score), in train
and eval mode.

Counterparts of ``fmri_tpu/models/nets.py`` (``EncoderBlock`` :58,
``DecoderBlock`` :95, ``VisualEncoder`` :130, ``CognitiveEncoder`` :153,
``Decoder`` :177, ``ImageDiscriminator`` :219, ``reparameterize`` :424). The
attribute names are the reference's torch ones (``conv.{i}.conv/.bn``,
``fc.0/.1``, ``l_mu``, ``l_var``, ``fc1.0/.1``, ``conv.3.0``, ``conv.0.0``,
``fc.3``), so its state dicts load with ``strict=True``.

BatchNorm: eps 1e-5 and momentum 0.9 as the new batch's weight (torch's
convention; the JAX package writes the same EMA as flax momentum 0.1,
``nets.py:33-36``). The BatchNorm after every conv and deconv is
:class:`fmri_tpu_torch.models.norm.BatchNorm2d`, whose train-mode backward
takes the hand-written kernels when ``ModelConfig.pallas_bn`` is set; the
FC BatchNorms are torch's own, as in the JAX package (not behind the flag).
The 5x5 convs and deconvs take their weight grad from ``ops/dw.py`` when
``ModelConfig.pallas_backward`` is set.

Modules compute in NCHW. Images cross their boundary in NHWC, the public
layout: ``VisualEncoder`` and ``ImageDiscriminator`` take NHWC and
``Decoder`` returns NHWC.
"""

from __future__ import annotations

import torch
from torch import nn

from fmri_tpu_torch.configs.presets import ModelConfig
from fmri_tpu_torch.models.norm import BN_EPS, BN_MOMENTUM, BatchNorm2d
from fmri_tpu_torch.ops.conv import conv2d, conv2d_transpose, linear


def _cd(cfg: ModelConfig) -> str | None:
    return None if cfg.compute_dtype in (None, "float32") else cfg.compute_dtype


def _bn1d(n: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(n, eps=BN_EPS, momentum=BN_MOMENTUM)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


class EncoderBlock(nn.Module):
    """Conv(k5, s2, p2, no bias) + BN + ReLU, with the pre-BN tap that feeds
    the discriminator's feature matching (reference ``vae_gan.py:11-35``)."""

    def __init__(self, cin: int, cout: int, cfg: ModelConfig):
        super().__init__()
        self.stride, self.padding = cfg.stride, cfg.padding
        self.compute_dtype = _cd(cfg)
        self.pallas_backward = cfg.pallas_backward
        self.conv = nn.Conv2d(cin, cout, cfg.kernel_size, cfg.stride, cfg.padding,
                              bias=False)
        self.bn = BatchNorm2d(cout, pallas=cfg.pallas_bn)

    def forward(self, x: torch.Tensor, tap: bool = False):
        pre_bn = conv2d(x, self.conv.weight, self.stride, self.padding,
                        self.compute_dtype, self.pallas_backward)
        y = torch.relu(self.bn(pre_bn))
        return (y, pre_bn) if tap else y


class DecoderBlock(nn.Module):
    """ConvTranspose(k5, s2, p2, no bias, output_padding) + BN + ReLU
    (reference ``vae_gan.py:38-60``)."""

    def __init__(self, cin: int, cout: int, output_pad: bool, cfg: ModelConfig):
        super().__init__()
        self.stride, self.padding = cfg.stride, cfg.padding
        self.output_padding = 1 if output_pad else 0
        self.compute_dtype = _cd(cfg)
        self.pallas_backward = cfg.pallas_backward
        self.conv = nn.ConvTranspose2d(
            cin, cout, cfg.kernel_size, cfg.stride, cfg.padding,
            output_padding=self.output_padding, bias=False)
        self.bn = BatchNorm2d(cout, pallas=cfg.pallas_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_transpose(x, self.conv.weight, self.stride, self.padding,
                             self.output_padding, self.compute_dtype,
                             self.pallas_backward)
        return torch.relu(self.bn(y))


class VisualEncoder(nn.Module):
    """Image [B, H, W, 3] -> (mu, logvar) [B, latent]
    (reference ``Encoder``, ``vae_gan.py:63-96``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.compute_dtype = _cd(cfg)
        chans = (3, *cfg.encoder_channels)
        self.conv = nn.Sequential(*[EncoderBlock(chans[i], chans[i + 1], cfg)
                                    for i in range(len(cfg.encoder_channels))])
        flat = cfg.fc_input * cfg.fc_input * cfg.encoder_channels[-1]
        self.fc = nn.Sequential(nn.Linear(flat, cfg.fc_output, bias=False),
                                _bn1d(cfg.fc_output), nn.ReLU())
        self.l_mu = nn.Linear(cfg.fc_output, cfg.latent_dim)
        self.l_var = nn.Linear(cfg.fc_output, cfg.latent_dim)

    def forward(self, x: torch.Tensor):
        cd = self.compute_dtype
        x = _nchw(x)
        for blk in self.conv:
            x = blk(x)
        x = linear(x.reshape(x.shape[0], -1), self.fc[0].weight, None, cd)
        x = torch.relu(self.fc[1](x))
        mu = linear(x, self.l_mu.weight, self.l_mu.bias, cd)
        logvar = linear(x, self.l_var.weight, self.l_var.bias, cd)
        return mu, logvar


class CognitiveEncoder(nn.Module):
    """fMRI voxels [B, V] -> (mu, logvar) [B, latent]
    (reference ``vae_gan.py:190-232``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.compute_dtype = _cd(cfg)
        self.fc1 = nn.Sequential(
            nn.Linear(cfg.num_voxels, cfg.cog_hidden, bias=False),
            _bn1d(cfg.cog_hidden), nn.ReLU())
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
        self.pallas_backward = cfg.pallas_backward
        self.size0, self.fc_input = cfg.encoder_channels[-1], cfg.fc_input
        flat = self.fc_input * self.fc_input * self.size0
        self.fc = nn.Sequential(nn.Linear(cfg.latent_dim, flat, bias=False),
                                _bn1d(flat), nn.ReLU())
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
        x = conv2d(x, out.weight, 1, 2, cd, self.pallas_backward) + out.bias.view(1, -1, 1, 1)
        return torch.tanh(x).permute(0, 2, 3, 1).contiguous()


class ImageDiscriminator(nn.Module):
    """Image [B, H, W, 3] -> (features [B, F], score [B, 1])
    (reference ``Discriminator``, ``vae_gan.py:135-187``), in one pass as the
    JAX module does: ``features`` is the flattened (C-major) pre-BN conv
    output of block ``recon_level``, ``score`` the sigmoid real/fake
    probability."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.compute_dtype = _cd(cfg)
        self.pallas_backward = cfg.pallas_backward
        self.stride_gan, self.recon_level = cfg.stride_gan, cfg.recon_level
        ch = cfg.discrim_channels
        layers = [nn.Sequential(nn.Conv2d(3, ch[0], 5, cfg.stride_gan, 2), nn.ReLU())]
        layers += [EncoderBlock(ch[i - 1], ch[i], cfg) for i in range(1, len(ch))]
        self.conv = nn.Sequential(*layers)
        flat = cfg.fc_input_gan * cfg.fc_input_gan * ch[-1]
        self.fc = nn.Sequential(
            nn.Linear(flat, cfg.fc_output_gan, bias=False), _bn1d(cfg.fc_output_gan),
            nn.ReLU(), nn.Linear(cfg.fc_output_gan, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor):
        cd = self.compute_dtype
        first = self.conv[0][0]
        x = conv2d(_nchw(x), first.weight, self.stride_gan, 2, cd,
                   self.pallas_backward)
        x = torch.relu(x + first.bias.view(1, -1, 1, 1))
        features = None
        for i in range(1, len(self.conv)):
            if i == self.recon_level:
                x, pre_bn = self.conv[i](x, tap=True)
                features = pre_bn.reshape(pre_bn.shape[0], -1)
            else:
                x = self.conv[i](x)
        x = linear(x.reshape(x.shape[0], -1), self.fc[0].weight, None, cd)
        x = torch.relu(self.fc[1](x))
        x = linear(x, self.fc[3].weight, self.fc[3].bias, cd)
        return features, torch.sigmoid(x)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(logvar / 2); ``eps`` comes from the caller's
    generator (``nets.py:424-427``)."""
    return mu + eps * torch.exp(0.5 * logvar)
