from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config

__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "smoke_config"]
