"""GQA attention layer: projections, qk-norm, RoPE, full-sequence
self-attention (causal, with the sliding window where the config has one)
and the dense-cache insert-then-attend protocol of decode (the port of that
subset of ``repro.models.attention``). The head counts are the effective
ones, so a head-padded layout (``transformer._init_attn``) runs as it is.
Not ported yet: ``prefill_attn``, cross-attention and the ring cache of a
window shorter than the context (``model.init_decode_state`` raises for
that state).

The attention itself is ``kernels.ops.attention`` (full sequence) or
``kernels.ops.decode_attention`` (one token): the CUDA kernel for CUDA
tensors, its plain version on the CPU; or, with ``impl="plain"``, the
plain version on any device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import kvcache
from repro_torch.models.layers import apply_rope, rms_norm, rope_angles

_ATTN_IMPLS = {"kernel": kops.attention, "plain": flash_attention_plain}
_DECODE_IMPLS = {"kernel": kops.decode_attention, "plain": decode_attention_plain}


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B,S,D) → q (B,S,H,Dh), k/v (B,S,Hkv,Dh)."""
    B, S, D = x.shape

    def proj(w):
        return (x @ w.to(x.dtype).reshape(D, -1)).reshape(B, S, w.shape[1],
                                                          w.shape[2])
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(cfg: ModelConfig, q, k, q_pos, kv_pos):
    cq, sq = rope_angles(q_pos, cfg.head_dim, cfg.rope_theta)
    ck, sk = rope_angles(kv_pos, cfg.head_dim, cfg.rope_theta)
    # positions (B,S) → angles (B,S,half) → broadcast over heads (B,S,1,half)
    return (apply_rope(q, cq[:, :, None], sq[:, :, None]),
            apply_rope(k, ck[:, :, None], sk[:, :, None]))


def _out_proj(p, o: torch.Tensor) -> torch.Tensor:
    B, S, H, Dh = o.shape
    return o.reshape(B, S, H * Dh) @ p["wo"].to(o.dtype).reshape(H * Dh, -1)


def apply_attn(cfg: ModelConfig, p, x: torch.Tensor, *, positions,
               impl: str = "kernel") -> torch.Tensor:
    """Full-sequence causal self-attention with RoPE (prefill). x (B,S,D),
    positions (B,S)."""
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions, positions)
    o = _ATTN_IMPLS[impl](q.contiguous(), k.contiguous(), v.contiguous(),
                          positions, positions, causal=True,
                          window=cfg.swa_window)
    return _out_proj(p, o)


def decode_attn(cfg: ModelConfig, p, x_new: torch.Tensor, cache: dict, pos, *,
                use_rope: bool = True, impl: str = "kernel"):
    """Single-token decode. x_new (B,1,D); ``pos`` = index of the new token,
    a (B,) int tensor of per-slot positions (continuous batching) or an
    int for a uniform batch. Inserts the new K/V into ``cache`` IN PLACE,
    then attends over the valid slots. → (out (B,1,D), cache)."""
    B = x_new.shape[0]
    per_slot = isinstance(pos, torch.Tensor) and pos.ndim == 1
    q, k, v = _project_qkv(cfg, p, x_new)
    if per_slot:
        q_pos = pos.to(torch.int32)[:, None]
    else:
        q_pos = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x_new.device)
    if use_rope:
        q, k = _rope_qk(cfg, q, k, q_pos, q_pos)

    if per_slot:
        kvcache.dense_cache_insert_rows(cache, k, v, pos)
        kv_pos = kvcache.dense_cache_positions_rows(cache, pos + 1)
    else:
        kvcache.dense_cache_insert(cache, k, v, int(pos))
        kv_pos = kvcache.dense_cache_positions(cache, int(pos) + 1)[None] \
            .expand(B, -1)

    o = _DECODE_IMPLS[impl](q.contiguous(), cache["k"].to(q.dtype),
                            cache["v"].to(q.dtype), q_pos, kv_pos,
                            causal=True, window=cfg.swa_window)
    return _out_proj(p, o), cache
