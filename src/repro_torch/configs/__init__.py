from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import (
    ARCH_IDS, FAMILY_DEFAULT_ARCH, get_config, smoke_config,
)

__all__ = ["ARCH_IDS", "FAMILY_DEFAULT_ARCH", "ModelConfig", "TrainConfig",
           "get_config", "smoke_config"]
