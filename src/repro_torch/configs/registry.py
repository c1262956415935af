"""Architecture registry: ``--arch <id>`` → ModelConfig (full + reduced smoke).

Only the architectures the port serves are registered; the rest of
``repro.configs.registry`` joins as their families are ported.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3p2_1b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).reduced()
