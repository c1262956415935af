"""Architecture registry: ``--arch <id>`` → ModelConfig (full + reduced smoke).

All ten architectures of ``repro.configs.registry``: the dense, MoE, SSM,
hybrid, encoder-decoder (whisper-tiny) and VLM (llava-next-mistral-7b)
families. grok-1-314b is here for its reduced config (its bf16 weights
fit no card).
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3p2_1b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
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
