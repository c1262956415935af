from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ServeConfig,
    replace,
)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ServeConfig", "replace",
           "ARCH_IDS", "get_config", "get_reduced"]
