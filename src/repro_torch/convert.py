"""Carry the JAX package's parameters over to the port.

JAX's random streams cannot be reproduced in PyTorch, so a parity test
initialises with ``repro.models.init_params``, turns every leaf into a
numpy array itself (``np.asarray``), and hands the tree here. This module
imports neither JAX nor ``repro``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve


def params_from_numpy(tree: Any, *, device="cuda") -> Any:
    """A nested dict of numpy arrays → the same dict of tensors on
    ``device``, with their dtypes and shapes, including the stacked leading
    L axis of the layer blocks."""
    dev = resolve(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.tensor(np.asarray(x), device=dev)

    return conv(tree)
