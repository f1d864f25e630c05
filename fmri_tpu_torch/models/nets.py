"""The VAE/GAN and WAE networks: ``VisualEncoder`` (image -> mu, logvar),
``CognitiveEncoder`` (fMRI voxels -> mu, logvar), ``Decoder`` (latent ->
image), ``ImageDiscriminator`` (image -> feature tap, score) and
``LatentDiscriminator`` (latent -> score), in train and eval mode; and the
ablations' ``VoxelDecoder`` (voxels -> image), ``WaeDecoder`` (the wide
decoder) and ``ResNetEncoder`` (image -> mu, logvar over a residual trunk).

Counterparts of ``fmri_tpu/models/nets.py`` (``EncoderBlock`` :58,
``DecoderBlock`` :95, ``VisualEncoder`` :130, ``CognitiveEncoder`` :153,
``Decoder`` :177, ``ImageDiscriminator`` :219, ``LatentDiscriminator`` :263,
``VoxelDecoder`` :287, ``WaeDecoder`` :323, ``_ResBlock`` :362,
``ResNetEncoder`` :382, ``reparameterize`` :424). The attribute names are the reference's torch
ones (``conv.{i}.conv/.bn``, ``fc.0/.1``, ``l_mu``, ``l_var``, ``fc1.0/.1``,
``conv.3.0``, ``conv.0.0``, ``fc.3``, ``main.{0,2,4,6,8}``), so its state
dicts load with ``strict=True``.

BatchNorm: eps 1e-5 and momentum 0.9 as the new batch's weight (torch's
convention; the JAX package writes the same EMA as flax momentum 0.1,
``nets.py:33-36``). The BatchNorm after every conv and deconv is
:class:`fmri_tpu_torch.models.norm.BatchNorm2d`, whose train-mode backward
takes the hand-written kernels when ``ModelConfig.pallas_bn`` is set; the
FC BatchNorms, and ``ResNetEncoder``'s, are not behind the flag, as in the
JAX package. ``Decoder.forward(z, vsplit=k)``
decodes k back-to-back latent batches in one pass with per-sub-batch
BatchNorm statistics (the fused decoder batch). The 5x5 convs and deconvs
take their weight grad from ``ops/dw.py`` when ``ModelConfig.pallas_backward``
is set. ``ModelConfig.alt_backward`` routes the convs that take it in the
JAX package (every ``EncoderBlock``, the discriminator's layer 0 and the
decoder's out conv) through the rewrites of ``ops/conv_alt.py`` where they
apply (``ops/conv.py``).

Modules compute in NCHW. Images cross their boundary in NHWC, the public
layout: ``VisualEncoder`` and ``ImageDiscriminator`` take NHWC and
``Decoder`` returns NHWC.

``CognitiveEncoder.fc1`` and ``Decoder``'s projection ``fc.0`` are
row-parallel once ``parallel.mesh.shard_state`` sets ``tp`` (the mesh):
the weight holds this model rank's input columns under its usual key, and
:func:`~fmri_tpu_torch.parallel.mesh.row_parallel_linear` sums the partial
products over the model group before the BatchNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fmri_tpu_torch.configs.presets import ModelConfig
from fmri_tpu_torch.models.norm import BatchNorm1d, BatchNorm2d
from fmri_tpu_torch.ops.conv import conv2d, conv2d_transpose, linear, same_pad
from fmri_tpu_torch.parallel.mesh import row_parallel_linear


def _cd(cfg: ModelConfig) -> str | None:
    return None if cfg.compute_dtype in (None, "float32") else cfg.compute_dtype


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _projection(x: torch.Tensor, weight: torch.Tensor, cd: str | None, tp) -> torch.Tensor:
    """The bias-free FC that a mesh's ``model`` axis may split by rows."""
    return linear(x, weight, None, cd) if tp is None else row_parallel_linear(x, weight, tp, cd)


class EncoderBlock(nn.Module):
    """Conv(k5, s2, p2, no bias) + BN + ReLU, with the pre-BN tap that feeds
    the discriminator's feature matching (reference ``vae_gan.py:11-35``)."""

    def __init__(self, cin: int, cout: int, cfg: ModelConfig):
        super().__init__()
        self.stride, self.padding = cfg.stride, cfg.padding
        self.compute_dtype = _cd(cfg)
        self.pallas_backward, self.alt_backward = cfg.pallas_backward, cfg.alt_backward
        self.conv = nn.Conv2d(cin, cout, cfg.kernel_size, cfg.stride, cfg.padding,
                              bias=False)
        self.bn = BatchNorm2d(cout, pallas=cfg.pallas_bn)

    def forward(self, x: torch.Tensor, tap: bool = False):
        pre_bn = conv2d(x, self.conv.weight, self.stride, self.padding,
                        self.compute_dtype, self.pallas_backward, self.alt_backward)
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

    def forward(self, x: torch.Tensor, vsplit: int = 1) -> torch.Tensor:
        y = conv2d_transpose(x, self.conv.weight, self.stride, self.padding,
                             self.output_padding, self.compute_dtype,
                             self.pallas_backward)
        return torch.relu(self.bn(y, vsplit))


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
                                BatchNorm1d(cfg.fc_output), nn.ReLU())
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
    (reference ``vae_gan.py:190-232``); ``fc1`` row-parallel under ``tp``."""

    tp = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.compute_dtype = _cd(cfg)
        self.fc1 = nn.Sequential(
            nn.Linear(cfg.num_voxels, cfg.cog_hidden, bias=False),
            BatchNorm1d(cfg.cog_hidden), nn.ReLU())
        self.l_mu = nn.Linear(cfg.cog_hidden, cfg.latent_dim)
        self.l_var = nn.Linear(cfg.cog_hidden, cfg.latent_dim)

    def forward(self, v: torch.Tensor):
        return self.forward_from_fc1(_projection(v, self.fc1[0].weight, self.compute_dtype,
                                                 self.tp))

    def forward_from_fc1(self, h: torch.Tensor):
        """(mu, logvar) from ``fc1``'s product [B, hidden], summed over the
        model group under ``tp``: the rest of :meth:`forward`, which serving
        over a mesh runs as a CUDA graph once the sum is in."""
        cd = self.compute_dtype
        x = torch.relu(self.fc1[1](h))
        mu = linear(x, self.l_mu.weight, self.l_mu.bias, cd)
        logvar = linear(x, self.l_var.weight, self.l_var.bias, cd)
        return mu, logvar


class Decoder(nn.Module):
    """Latent [B, latent] -> image [B, H, W, 3] in [-1, 1]
    (reference ``vae_gan.py:99-132``): FC + BN + ReLU, three deconv blocks,
    5x5 out-conv + bias, tanh.

    ``in_features`` (default ``latent_dim``) and ``chans`` (the FC's
    channels, then each block's; default ``(size0, size0,
    decoder_channels[1], decoder_channels[2])``) let :class:`VoxelDecoder`
    and :class:`WaeDecoder` reuse it; ``fc[2]`` is the FC's activation.
    The FC is row-parallel under ``tp``."""

    tp = None

    def __init__(self, cfg: ModelConfig, in_features: int | None = None,
                 chans: tuple | None = None):
        super().__init__()
        self.compute_dtype = _cd(cfg)
        self.pallas_backward, self.alt_backward = cfg.pallas_backward, cfg.alt_backward
        size0 = cfg.encoder_channels[-1]
        chans = chans or (size0, size0, cfg.decoder_channels[1], cfg.decoder_channels[2])
        self.size0, self.fc_input = chans[0], cfg.fc_input
        flat = self.fc_input * self.fc_input * self.size0
        self.fc = nn.Sequential(nn.Linear(in_features or cfg.latent_dim, flat, bias=False),
                                BatchNorm1d(flat), nn.ReLU())
        blocks = [DecoderBlock(chans[i], chans[i + 1], cfg.output_pad_dec[i], cfg)
                  for i in range(3)]
        out = nn.Sequential(
            nn.Conv2d(chans[3], cfg.decoder_channels[3], 5, 1, 2), nn.Tanh())
        self.conv = nn.Sequential(*blocks, out)

    def forward(self, z: torch.Tensor, vsplit: int = 1) -> torch.Tensor:
        """``vsplit=k``: z holds k back-to-back latent batches, decoded in one
        pass with each sub-batch's own BatchNorm statistics (train mode)."""
        cd = self.compute_dtype
        x = _projection(z, self.fc[0].weight, cd, self.tp)
        x = self.fc[2](self.fc[1](x, vsplit))
        # C-major flatten, as the reference's view(B, C, H, W)
        x = x.view(x.shape[0], self.size0, self.fc_input, self.fc_input)
        for blk in self.conv[:3]:
            x = blk(x, vsplit)
        out = self.conv[3][0]
        x = conv2d(x, out.weight, 1, 2, cd, self.pallas_backward,
                   self.alt_backward) + out.bias.view(1, -1, 1, 1)
        return torch.tanh(x).permute(0, 2, 3, 1).contiguous()


class VoxelDecoder(Decoder):
    """fMRI voxels [B, V] -> image: the supervised decoder of the
    ``exp_decoder`` ablation (``fmri_tpu/models/nets.py:287``), a
    :class:`Decoder` whose FC reads the voxels and whose FC activation is
    **tanh** (``experiments/exp_decoder.py:172-174``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg, in_features=cfg.num_voxels)
        self.fc[2] = nn.Tanh()


class WaeDecoder(Decoder):
    """The wide decoder (``fmri_tpu/models/nets.py:323``; dead code in the
    reference, ``vae_gan.py:625-655``): FC to ``fc_input^2 * 1024`` + BN +
    ReLU, blocks 1024 -> 512 -> 256 -> 128, conv to 3 channels, tanh. The FC
    width follows ``fc_input``, the JAX package's fix of the reference's
    hard-coded ``16 * 16 * 1024``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg, chans=(1024, 512, 256, 128))


def _same_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    return F.conv2d(same_pad(x, w.shape[-1], stride), w, stride=stride)


# ResNetEncoder's two hidden FC widths (the reference's fc_hidden1/2)
RESNET_FC_HIDDEN = (1024, 768)


class _ResBlock(nn.Module):
    """3x3 conv (stride) + BN + ReLU, 3x3 conv + BN, a 1x1 conv (stride) +
    BN shortcut where the shape changes, ReLU of the sum
    (``fmri_tpu/models/nets.py:362``); SAME padding, no bias."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, bias=False)
        self.bn2 = BatchNorm2d(cout)
        if cin != cout or stride != 1:
            self.proj = nn.Conv2d(cin, cout, 1, bias=False)
            self.proj_bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(_same_conv(x, self.conv1.weight, self.stride)))
        h = self.bn2(_same_conv(h, self.conv2.weight, 1))
        if hasattr(self, "proj"):
            x = self.proj_bn(_same_conv(x, self.proj.weight, self.stride))
        return torch.relu(h + x)


class ResNetEncoder(nn.Module):
    """Image [B, H, W, 3] -> (mu, logvar): the residual VAE encoder
    (``fmri_tpu/models/nets.py:382``; dead code in the reference,
    ``vae_gan.py:658-702``). The trunk is the compact one trained from
    scratch (7x7 stride-2 stem + BN + ReLU, four :class:`_ResBlock`s of
    64/128/256/512 channels, the spatial mean) or ``trunk``, a frozen module
    of NHWC images -> [B, ``trunk.out_features``] such as
    :func:`fmri_tpu_torch.models.resnet152.resnet152_trunk_fn`'s (its
    weights are buffers outside the state dict). Then ``fc1`` (1024) + BN +
    ReLU, ``fc2`` (768) + BN + ReLU and the ``fc3_mu`` / ``fc3_logvar``
    heads, the reference's names. The convs pad as Flax's ``'SAME'``
    (:func:`~fmri_tpu_torch.ops.conv.same_pad`), fp32 cuDNN calls on the
    card. The head's widths are :data:`RESNET_FC_HIDDEN`: the JAX module's
    ``fc_hidden1`` / ``fc_hidden2`` fields, which no caller sets."""

    def __init__(self, cfg: ModelConfig, trunk: nn.Module | None = None):
        super().__init__()
        if trunk is None:
            self.stem = nn.Conv2d(3, 64, 7, bias=False)
            self.stem_bn = BatchNorm2d(64)
            self.blocks = nn.Sequential(*[_ResBlock(cin, cout, s) for cin, cout, s in (
                (64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2))])
            features = 512
        else:
            self.trunk, features = trunk, trunk.out_features
        hidden1, hidden2 = RESNET_FC_HIDDEN
        self.fc1 = nn.Linear(features, hidden1)
        self.bn1 = BatchNorm1d(hidden1)
        self.fc2 = nn.Linear(hidden1, hidden2)
        self.bn2 = BatchNorm1d(hidden2)
        self.fc3_mu = nn.Linear(hidden2, cfg.latent_dim)
        self.fc3_logvar = nn.Linear(hidden2, cfg.latent_dim)

    def forward(self, x: torch.Tensor):
        if hasattr(self, "trunk"):
            h = self.trunk(x)
        else:
            h = torch.relu(self.stem_bn(_same_conv(_nchw(x), self.stem.weight, 2)))
            h = self.blocks(h).mean(dim=(2, 3))
        h = torch.relu(self.bn1(self.fc1(h)))
        h = torch.relu(self.bn2(self.fc2(h)))
        return self.fc3_mu(h), self.fc3_logvar(h)


class ImageDiscriminator(nn.Module):
    """Image [B, H, W, 3] -> (features [B, F], score [B, 1])
    (reference ``Discriminator``, ``vae_gan.py:135-187``), in one pass as the
    JAX module does: ``features`` is the flattened (C-major) pre-BN conv
    output of block ``recon_level``, ``score`` the sigmoid real/fake
    probability."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.compute_dtype = _cd(cfg)
        self.pallas_backward, self.alt_backward = cfg.pallas_backward, cfg.alt_backward
        self.stride_gan, self.recon_level = cfg.stride_gan, cfg.recon_level
        ch = cfg.discrim_channels
        layers = [nn.Sequential(nn.Conv2d(3, ch[0], 5, cfg.stride_gan, 2), nn.ReLU())]
        layers += [EncoderBlock(ch[i - 1], ch[i], cfg) for i in range(1, len(ch))]
        self.conv = nn.Sequential(*layers)
        flat = cfg.fc_input_gan * cfg.fc_input_gan * ch[-1]
        self.fc = nn.Sequential(
            nn.Linear(flat, cfg.fc_output_gan, bias=False),
            BatchNorm1d(cfg.fc_output_gan),
            nn.ReLU(), nn.Linear(cfg.fc_output_gan, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor):
        cd = self.compute_dtype
        first = self.conv[0][0]
        x = conv2d(_nchw(x), first.weight, self.stride_gan, 2, cd,
                   self.pallas_backward, self.alt_backward)
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


class LatentDiscriminator(nn.Module):
    """Latent [B, latent] -> score [B, 1]: 4 x [Linear(``wae_disc_hidden``)
    + ReLU], Linear(1), sigmoid (reference ``WaeDiscriminator``,
    ``vae_gan.py:499-529``), as the ``nn.Sequential`` ``main``, so the
    reference keys ``main.{0,2,4,6,8}.*`` load strictly. Bf16 operands with
    the compute dtype, as the JAX module's ``Dense(dtype=...)``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.compute_dtype = _cd(cfg)
        h, layers = cfg.wae_disc_hidden, []
        for i in range(4):
            layers += [nn.Linear(cfg.latent_dim if i == 0 else h, h), nn.ReLU()]
        self.main = nn.Sequential(*layers, nn.Linear(h, 1), nn.Sigmoid())

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for i in range(0, 10, 2):
            x = linear(x, self.main[i].weight, self.main[i].bias, self.compute_dtype)
            x = torch.relu(x) if i < 8 else torch.sigmoid(x)
        return x

    @torch.no_grad()
    def init_weights(self, scheme: str) -> "LatentDiscriminator":
        """``"normal"``: weights N(0, 0.01), the ctor init
        (``vae_gan.py:522-525``); ``"uniform"``: U(-a, a), a =
        1/sqrt(3 * fan_in), the ``WaeGan`` re-init (``vae_gan.py:452-464``).
        Biases 0 either way, as the JAX module draws them."""
        if scheme not in ("normal", "uniform"):
            raise ValueError(f"init scheme must be 'normal' or 'uniform', got {scheme!r}")
        for m in self.main:
            if isinstance(m, nn.Linear):
                if scheme == "normal":
                    m.weight.normal_(0.0, 0.01)
                else:
                    a = (3.0 * m.weight.shape[1]) ** -0.5
                    m.weight.uniform_(-a, a)
                m.bias.zero_()
        return self


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(logvar / 2); ``eps`` comes from the caller's
    generator (``nets.py:424-427``)."""
    return mu + eps * torch.exp(0.5 * logvar)
