"""The VAE/GAN and WAE eval modules: an encoder and the decoder,
reconstruction and decoding from the prior.

* :class:`VaeGanCognitive`: fMRI -> image, the counterpart of
  ``make_vgan_cognitive_step``'s ``eval_step``
  (``fmri_tpu/train/steps_vgan.py:591-604``);
* :class:`VaeGanVisual`: image -> image, the stage-I ``eval_step``
  (``steps_vgan.py:273-286``), and WAE/Dual-GAN's
  (``fmri_tpu/train/steps_wae.py:575-584``);
* :class:`WaeVisual`, :class:`WaeCognitive`: the WAE ``eval_step`` of stage
  I and of stages II/III (``steps_wae.py:149-157, 301-309``), which always
  decode mu: they take no sample.

``generate`` is ``generate_step`` (``steps_vgan.py:54-63``).
:func:`eval_module` picks the module of a family and stage. Noise comes
from the caller (its own ``torch.Generator``), so tests can inject the same
draws into both packages.
"""

from __future__ import annotations

import torch
from torch import nn

from fmri_tpu_torch.configs.presets import ModelConfig
from fmri_tpu_torch.models.nets import (
    CognitiveEncoder, Decoder, VisualEncoder, reparameterize,
)


class _EvalVaeGan(nn.Module):
    """``encoder`` + ``decoder``, the ``encoder.*``/``decoder.*`` part of a
    reference state dict. Kept in eval mode: BatchNorm uses running
    statistics, so padded rows cannot perturb real ones."""

    samples = True  # reparameterise when reconstruct() is given eps

    def __init__(self, cfg: ModelConfig, encoder: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.encoder = encoder
        self.decoder = Decoder(cfg)
        self.eval()

    @torch.no_grad()
    def reconstruct(self, x: torch.Tensor,
                    eps: torch.Tensor | None = None) -> torch.Tensor:
        """The encoder's input -> [B, H, W, 3] in [-1, 1]. z = mu, or
        mu + eps * exp(logvar / 2) when ``eps`` is given and the model
        samples."""
        return self.decode_posterior(*self.encoder(x), eps)

    @torch.no_grad()
    def decode_posterior(self, mu: torch.Tensor, logvar: torch.Tensor,
                         eps: torch.Tensor | None = None) -> torch.Tensor:
        """The decoder on the encoder's posterior: z = mu, or the
        reparameterized sample when ``eps`` is given and the model samples."""
        z = mu if eps is None or not self.samples else reparameterize(mu, logvar, eps)
        return self.decoder(z)

    @torch.no_grad()
    def generate(self, z: torch.Tensor) -> torch.Tensor:
        """Decode prior draws z ~ N(0, I) [n, latent] with BatchNorm running
        statistics (the reference's ``model(None)`` branch,
        ``vae_gan.py:294-297``)."""
        return self.decoder(z)


class VaeGanCognitive(_EvalVaeGan):
    """fMRI voxels [B, V] -> image: the inference part of the reference's
    ``VaeGanCognitive`` (``vae_gan.py:323-432``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg, CognitiveEncoder(cfg))


class VaeGanVisual(_EvalVaeGan):
    """Normalized NHWC images -> image: the inference part of the stage-I
    ``VaeGan`` (``vae_gan.py:235-320``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg, VisualEncoder(cfg))


class WaeCognitive(VaeGanCognitive):
    """fMRI voxels [B, V] -> image through the mean latent: the inference
    part of the reference's ``WaeGanCognitive`` (``vae_gan.py:532-578``)."""

    samples = False


class WaeVisual(VaeGanVisual):
    """Normalized NHWC images -> image through the mean latent: the
    inference part of the reference's ``WaeGan`` (``vae_gan.py:435-496``)."""

    samples = False


def eval_module(family: str, stage: int) -> "tuple[type[_EvalVaeGan], str]":
    """(eval module class, data kind) of a family and stage, mapped as the
    JAX package's ``make_step_fns`` maps them
    (``fmri_tpu/eval/inference.py:73-89``): ``wae-vgan`` at any stage and
    stage I of ``vgan`` and ``wae`` take images (``"image"``), stages II
    and III fMRI (``"pair"``)."""
    if family == "wae-vgan" or (family == "vgan" and stage == 1):
        cls = VaeGanVisual
    elif family == "vgan":
        cls = VaeGanCognitive
    elif family == "wae":
        cls = WaeVisual if stage == 1 else WaeCognitive
    else:
        raise ValueError(f"unknown family {family!r}; one of vgan, wae, wae-vgan")
    return cls, "image" if issubclass(cls, VaeGanVisual) else "pair"
