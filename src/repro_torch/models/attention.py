"""GQA attention layer: projections, qk-norm, RoPE, full-sequence
self-attention (causal or not, with the sliding window where the config
has one), decoder → encoder cross-attention, the prefill that fills a
dense cache, and the insert-then-attend protocol of decode over a dense
cache, a ring cache or a static encoder K/V (the port of
``repro.models.attention``). The head counts are the effective ones, so a
head-padded layout (``transformer._init_attn``) runs as it is.

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


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor, x_kv=None):
    """x (B,S,D) → q (B,S,H,Dh), k/v (B,Skv,Hkv,Dh); k and v are projected
    from ``x_kv`` (B,Skv,D) when given (cross-attention), else from x."""
    D = x.shape[-1]
    xk = x if x_kv is None else x_kv

    def proj(t, w):
        return (t @ w.to(x.dtype).reshape(D, -1)).reshape(*t.shape[:2], w.shape[1],
                                                          w.shape[2])
    q, k, v = proj(x, p["wq"]), proj(xk, p["wk"]), proj(xk, p["wv"])
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
               causal: bool = True, use_rope: bool = True,
               impl: str = "kernel") -> torch.Tensor:
    """Full-sequence self-attention (train / prefill): causal or not, RoPE
    or not, within the config's window. x (B,S,D), positions (B,S)."""
    q, k, v = _project_qkv(cfg, p, x)
    if use_rope:
        q, k = _rope_qk(cfg, q, k, positions, positions)
    o = _ATTN_IMPLS[impl](q.contiguous(), k.contiguous(), v.contiguous(),
                          positions, positions, causal=causal,
                          window=cfg.swa_window)
    return _out_proj(p, o)


def _arange_rows(B: int, S: int, device) -> torch.Tensor:
    """Positions 0..S-1 for each of B rows, (B, S) int32."""
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def apply_cross_attn(cfg: ModelConfig, p, x: torch.Tensor, enc_out: torch.Tensor,
                     enc_pos, *, impl: str = "kernel") -> torch.Tensor:
    """Decoder → encoder cross-attention: queries from x (B,S,D), keys and
    values from enc_out (B,Se,D) at ``enc_pos`` (B,Se); non-causal, no
    RoPE, no window."""
    q, k, v = _project_qkv(cfg, p, x, x_kv=enc_out)
    B, S = x.shape[:2]
    o = _ATTN_IMPLS[impl](q.contiguous(), k.contiguous(), v.contiguous(),
                          _arange_rows(B, S, x.device), enc_pos, causal=False,
                          window=None)
    return _out_proj(p, o)


def prefill_attn(cfg: ModelConfig, p, x: torch.Tensor, cache: dict, *, positions,
                 use_rope: bool = True, impl: str = "kernel"):
    """Causal self-attention that also fills a dense ``cache`` (in place)
    from position 0 with the sequence's K/V. → (out (B,S,D), cache)."""
    q, k, v = _project_qkv(cfg, p, x)
    if use_rope:
        q, k = _rope_qk(cfg, q, k, positions, positions)
    kvcache.dense_cache_insert(cache, k, v, 0)
    o = _ATTN_IMPLS[impl](q.contiguous(), k.contiguous(), v.contiguous(),
                          positions, positions, causal=True,
                          window=cfg.swa_window)
    return _out_proj(p, o), cache


def decode_attn(cfg: ModelConfig, p, x_new: torch.Tensor, cache: dict, pos, *,
                use_rope: bool = True, impl: str = "kernel", cross: bool = False):
    """Single-token decode. x_new (B,1,D); ``pos`` = index of the new token,
    a (B,) int tensor of per-slot positions (continuous batching) or an
    int for a uniform batch. A dense cache takes the new K/V IN PLACE,
    then the valid slots are attended; a ring cache (``"slot_pos"``, int
    positions only) takes it at slot ``pos % W``, and its slots' absolute
    positions do the masking; with ``cross=True`` the cache is a static
    encoder K/V, attended non-causally with nothing inserted.
    → (out (B,1,D), cache)."""
    B = x_new.shape[0]
    per_slot = isinstance(pos, torch.Tensor) and pos.ndim == 1
    q, k, v = _project_qkv(cfg, p, x_new)
    if per_slot:
        q_pos = pos.to(torch.int32)[:, None]
    else:
        q_pos = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x_new.device)

    if cross:
        kv_pos = _arange_rows(B, cache["k"].shape[1], x_new.device)
        o = _DECODE_IMPLS[impl](q.contiguous(), cache["k"].to(q.dtype),
                                cache["v"].to(q.dtype), q_pos, kv_pos,
                                causal=False, window=None)
        return _out_proj(p, o), cache

    if use_rope:
        q, k = _rope_qk(cfg, q, k, q_pos, q_pos)

    if "slot_pos" in cache:                       # sliding-window ring
        if per_slot:
            raise ValueError("ring caches require uniform decode positions")
        kvcache.ring_cache_insert(cache, k, v, pos)
        kv_pos = cache["slot_pos"][None].expand(B, -1)
    elif per_slot:
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
