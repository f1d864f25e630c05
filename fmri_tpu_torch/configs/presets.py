"""Frozen configuration dataclasses and named presets.

The port's own copy of ``fmri_tpu/configs/presets.py`` (the port imports
nothing from ``fmri_tpu``); ``tests/test_torch_models.py`` holds every preset
field-for-field against the reference. What reads the flags (all off in
every preset, as in the JAX package):
  * ``pallas_bn`` (``models/norm.py``) and ``pallas_backward``
    (``ops/conv.py``) route the train steps' BatchNorm backward and conv
    weight grads through the port's CUDA kernels;
  * ``fused_decoder_batch`` (``train/steps_vgan.py``, ``train/steps_wae.py``)
    decodes a step's latent batches in one pass with ``vsplit`` BatchNorm;
  * ``alt_backward`` (``ops/conv.py``) routes the conv backward through the
    rewrites of ``ops/conv_alt.py`` where they apply.

Presets:
  * ``res64``  — image_size=64,  latent_dim=128
  * ``res100`` — image_size=100, latent_dim=512 (the paper setting)
  * ``tiny``   — 16 px, narrow widths, for tests
  * ``fullbrain`` — res64 over a 98,304-voxel input
  * ``*-bf16`` — the same with bf16 conv/matmul operands, fp32 elsewhere
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (reference ``configs/models_config.py``)."""

    image_size: int = 64
    latent_dim: int = 128
    kernel_size: int = 5
    stride: int = 2
    padding: int = 2
    encoder_channels: Sequence[int] = (64, 128, 256)
    decoder_channels: Sequence[int] = (256, 128, 64, 3)
    discrim_channels: Sequence[int] = (32, 128, 256, 256)
    # spatial size entering/leaving the FC bottleneck
    fc_input: int = 8
    fc_output: int = 1024
    fc_input_gan: int = 8
    fc_output_gan: int = 512
    stride_gan: int = 1
    # output_padding of the three decoder deconvs: True -> 1 (exact doubling)
    output_pad_dec: Sequence[bool] = (True, True, True)
    recon_level: int = 3
    # CognitiveEncoder input width: BOLD5000 padded-ROI voxel count
    num_voxels: int = 3620
    cog_hidden: int = 1024
    wae_disc_hidden: int = 512
    # None/'float32' (reference parity) or 'bfloat16' (bf16 conv/matmul
    # operands, fp32 results, fp32 params and BatchNorm)
    compute_dtype: str | None = None
    fused_decoder_batch: bool = False
    pallas_backward: bool = False
    alt_backward: bool = False
    pallas_bn: bool = False

    @property
    def fc_flat(self) -> int:
        return self.fc_input * self.fc_input * self.encoder_channels[-1]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input-pipeline parameters (reference ``configs/gan_config.py``)."""

    image_crop: int = 375
    image_size: int = 64
    mean: Sequence[float] = (0.5, 0.5, 0.5)
    std: Sequence[float] = (0.5, 0.5, 0.5)
    max_shift: int = 5
    num_voxels: int = 3620
    split_seed: int = 12345
    data_split: float = 0.2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer hyper-parameters (reference ``configs/gan_config.py`` /
    ``configs/wae_config.py``)."""

    batch_size: int = 64
    learning_rate: float = 1e-4
    n_epochs: int = 200
    rms_decay: float = 0.9
    rms_eps: float = 1e-8
    decay_lr: float = 0.98
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    step_size: int = 30
    step_gamma: float = 0.5
    margin: float = 0.35
    equilibrium: float = 0.68
    decay_margin: float = 1.0
    decay_equilibrium: float = 1.0
    lambda_mse: float = 1e-6
    decay_mse: float = 1.0
    beta: float = 1.0
    wae_lambda: float = 10.0
    wae_vgan_lam: float = 1.0
    wae_sigma: float = 0.5
    grad_clip: float | None = None
    seed: int = 8
    ckpt_every: int = 5
    eval_every: int = 1
    patience: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _res64() -> Config:
    return Config(
        model=ModelConfig(
            image_size=64, latent_dim=128, fc_input=8, fc_output=1024,
            fc_input_gan=8, fc_output_gan=512, stride_gan=1,
            output_pad_dec=(True, True, True),
        ),
        data=DataConfig(image_size=64),
        train=TrainConfig(batch_size=64, n_epochs=200),
    )


def _res100() -> Config:
    return Config(
        model=ModelConfig(
            image_size=100, latent_dim=512, fc_input=13, fc_output=1024,
            fc_input_gan=7, fc_output_gan=256, stride_gan=2,
            output_pad_dec=(False, True, True),
        ),
        data=DataConfig(image_size=100),
        train=TrainConfig(batch_size=100, n_epochs=400),
    )


def _tiny() -> Config:
    return Config(
        model=ModelConfig(
            image_size=16, latent_dim=16, fc_input=2, fc_output=32,
            fc_input_gan=2, fc_output_gan=32, stride_gan=1,
            encoder_channels=(8, 16, 16), decoder_channels=(16, 8, 8, 3),
            discrim_channels=(8, 16, 16, 16),
            output_pad_dec=(True, True, True),
            num_voxels=128, cog_hidden=32, wae_disc_hidden=32,
        ),
        data=DataConfig(image_size=16, image_crop=20, num_voxels=128),
        train=TrainConfig(batch_size=8, n_epochs=2),
    )


def override_num_voxels(cfg: Config, n: int) -> Config:
    """Apply a measured voxel count to both the model and data configs (the
    reference sizes the CognitiveEncoder from the data,
    ``train_vgan_stage2.py:182``)."""
    if n < 1:
        raise ValueError(f"num_voxels must be >= 1, got {n}")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, num_voxels=n),
        data=dataclasses.replace(cfg.data, num_voxels=n),
    )


def _fullbrain() -> Config:
    """res64 over a whole-brain voxel vector (98,304 voxels, a gray-matter
    scale count) instead of the 3,620-voxel ROI concatenation."""
    return override_num_voxels(_res64(), 98304)


def _with_bf16(cfg: Config) -> Config:
    return Config(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
                  data=cfg.data, train=cfg.train)


RES64: Config = _res64()
RES100: Config = _res100()
TINY: Config = _tiny()
FULLBRAIN: Config = _fullbrain()
RES64_BF16: Config = _with_bf16(RES64)
RES100_BF16: Config = _with_bf16(RES100)
FULLBRAIN_BF16: Config = _with_bf16(FULLBRAIN)

PRESETS = {"res64": RES64, "res100": RES100, "tiny": TINY,
           "res64-bf16": RES64_BF16, "res100-bf16": RES100_BF16,
           "fullbrain": FULLBRAIN, "fullbrain-bf16": FULLBRAIN_BF16}


def get_config(name: str = "res64") -> Config:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
