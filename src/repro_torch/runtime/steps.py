"""Step functions for serving: prefill and decode (the port of the serving
part of ``repro.runtime.steps``; ``make_train_step`` joins with training).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward
from repro_torch.models.transformer import Impl


def make_prefill_step(cfg: ModelConfig, impl: Impl = Impl(),
                      dtype=torch.bfloat16):
    """Serving prefill: full-context forward, next-token logits only.
    → prefill_step(params, {"tokens": (B, S)}) → logits (B, 1, Vp) f32."""
    def prefill_step(params, batch):
        logits, _ = forward(cfg, params, batch, impl=impl, dtype=dtype,
                            last_only=True)
        return logits
    return prefill_step


def make_decode_step(cfg: ModelConfig, impl: Impl = Impl(),
                     dtype=torch.bfloat16):
    """Serving decode: one token through the cached stack.
    → serve_step(params, state, token (B, 1)) → (logits (B, 1, Vp), state)."""
    def serve_step(params, state, token):
        return decode_step(cfg, params, state, token, impl=impl, dtype=dtype)
    return serve_step
