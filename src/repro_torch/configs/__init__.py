from repro_torch.configs.base import SHAPES, ModelConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import (
    ARCH_IDS, CNN_ARCHS, FAMILY_DEFAULT_ARCH, LONG_CONTEXT_OK, cells, get_config, get_shape,
    smoke_config,
)

__all__ = ["ARCH_IDS", "CNN_ARCHS", "FAMILY_DEFAULT_ARCH", "LONG_CONTEXT_OK", "ModelConfig",
           "RunConfig", "SHAPES", "ShapeConfig", "TrainConfig", "cells", "get_config",
           "get_shape", "smoke_config"]
