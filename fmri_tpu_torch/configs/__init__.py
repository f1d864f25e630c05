from fmri_tpu_torch.configs.presets import (  # noqa: F401
    PRESETS, RES64, RES100, TINY, Config, DataConfig, ModelConfig, TrainConfig,
    get_config, override_num_voxels,
)
