"""Decode state for serving: dense KV caches, sliding-window ring caches and
the SSM recurrent state (the port of ``repro.models.kvcache``).

A layer's cache is ``{"k", "v"}`` of (B, S_max, H_kv, Dh); a ring cache
adds ``"slot_pos"`` (W,), the absolute position each of its W slots holds
(-1: empty); the SSM family's is ``{"ssd", "conv"}``. A stack's caches
carry a leading L axis, as the reference's ``stack_caches`` makes them.
Inserts write IN PLACE into the given tensors (the reference returns new
arrays) and return the same dict.

An insert position past the end is clamped to the last slot, as
``jax.lax.dynamic_update_slice`` clamps its start index: the serving
engine keeps advancing the position of an idle slot, so the case is
reached.
"""
from __future__ import annotations

import torch


def init_dense_cache(n_layers: int, batch: int, max_seq: int, n_kv: int,
                     head_dim: int, dtype, device) -> dict:
    """Zeroed caches of a layer stack: {"k", "v"} of (L, B, S_max, H_kv, Dh)."""
    shape = (n_layers, batch, max_seq, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_ssm_state(n_layers: int, batch: int, n_heads: int, head_dim: int,
                   d_state: int, conv_width: int, conv_channels: int, dtype,
                   device) -> dict:
    """Zeroed Mamba2 states of a layer stack: {"ssd" (L, B, H, P, N) f32,
    "conv" (L, B, cw-1, C) in ``dtype``}."""
    return {"ssd": torch.zeros((n_layers, batch, n_heads, head_dim, d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((n_layers, batch, conv_width - 1, conv_channels),
                                dtype=dtype, device=device)}


def dense_cache_insert(cache: dict, k_new, v_new, pos: int) -> dict:
    """Insert (B, S_new, H, D) at sequence offset ``pos`` (in place)."""
    s_max, s_new = cache["k"].shape[1], k_new.shape[1]
    start = min(max(int(pos), 0), s_max - s_new)
    cache["k"][:, start:start + s_new] = k_new.to(cache["k"].dtype)
    cache["v"][:, start:start + s_new] = v_new.to(cache["v"].dtype)
    return cache


def dense_cache_positions(cache: dict, length) -> torch.Tensor:
    """kv positions (S_max,) with slots >= length masked as -1."""
    s = cache["k"].shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=cache["k"].device)
    return torch.where(pos < length, pos, -1)


def dense_cache_insert_rows(cache: dict, k_new, v_new, pos_b) -> dict:
    """Per-slot insert for continuous batching (in place): row b gets its
    token at its own position pos_b[b], clamped to [0, S_max - 1].
    k_new/v_new (B, 1, H, D); pos_b (B,) int."""
    s_max = cache["k"].shape[1]
    rows = torch.arange(cache["k"].shape[0], device=cache["k"].device)
    at = pos_b.to(torch.int64).clamp(0, s_max - 1)
    cache["k"][rows, at] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, at] = v_new[:, 0].to(cache["v"].dtype)
    return cache


def init_ring_cache(n_layers: int, batch: int, window: int, n_kv: int,
                    head_dim: int, dtype, device) -> dict:
    """Empty ring caches of a layer stack: {"k", "v"} of (L, B, W, H_kv,
    Dh) zeroed and "slot_pos" (L, W) int32 filled with -1."""
    shape = (n_layers, batch, window, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((n_layers, window), -1, dtype=torch.int32,
                                   device=device)}


def ring_cache_insert(cache: dict, k_new, v_new, pos: int) -> dict:
    """Insert one token (B, 1, H, D) at absolute position ``pos`` (in
    place): slot ``pos % W`` takes its K/V and ``slot_pos[slot] = pos``.
    ``pos`` is one scalar for the whole batch, as in the reference; the
    slot is computed on the host, so the insert does not sync."""
    slot = int(pos) % cache["k"].shape[1]
    # one-slot slices, not an index: a cache split along its slots (the dry
    # run on a mesh) takes a slice as the dense insert's, not an int index
    cache["k"][:, slot:slot + 1] = k_new.to(cache["k"].dtype)
    cache["v"][:, slot:slot + 1] = v_new.to(cache["v"].dtype)
    cache["slot_pos"][slot:slot + 1] = int(pos)
    return cache


def dense_cache_positions_rows(cache: dict, lengths) -> torch.Tensor:
    """(B, S_max) kv positions with per-row valid lengths."""
    s = cache["k"].shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=cache["k"].device)[None]
    return torch.where(pos < lengths.to(torch.int32)[:, None], pos, -1)
