from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    SSMConfig,
    ServeConfig,
    ShapeConfig,
    ShardingConfig,
    TrainConfig,
    replace,
    shape_applicable,
)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced

__all__ = ["SHAPES", "SHAPES_BY_NAME", "ModelConfig", "MoEConfig",
           "OptimizerConfig", "SSMConfig", "ServeConfig", "ShapeConfig",
           "ShardingConfig", "TrainConfig", "replace", "shape_applicable",
           "ARCH_IDS", "get_config", "get_reduced"]
