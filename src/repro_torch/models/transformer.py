"""Dense decoder blocks and the decode stack (the port of the dense-decode
subset of ``repro.models.transformer``).

Layer parameters are stacked on a leading L axis, as the reference's
``init_stack`` produces them; :func:`decode_stack` walks the stack with a
Python loop and updates the stacked KV caches in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, apply_norm


@dataclass(frozen=True)
class Impl:
    """Kernel selection. ``decode_attention="kernel"`` routes through
    ``kernels.ops`` (the CUDA kernel for CUDA tensors, the plain version on
    the CPU); ``"plain"`` runs the plain PyTorch version on any device."""
    decode_attention: str = "kernel"

    def __post_init__(self):
        if self.decode_attention not in ("kernel", "plain"):
            raise ValueError(f"unknown decode_attention impl "
                             f"{self.decode_attention!r}")


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe or cfg.enc_dec or cfg.swa_window:
        raise NotImplementedError(
            f"{cfg.name}: only dense full-attention models are ported yet")


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, drawn in f32 on the generator's
    device (the reference's ``layers.dense_init``)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(1.0 / max(1, fan_in) ** 0.5).to(dtype)


def init_stack(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
               dtype=torch.float32) -> dict:
    """``n_layers`` dense blocks stacked on a leading L axis: the tree of
    the reference's ``init_stack`` (ln1, attn {wq, wk, wv, wo}, ln2,
    ffn {up, down, gate})."""
    _check_dense(cfg)
    if cfg.q_heads_eff != cfg.num_heads or cfg.kv_heads_eff != cfg.num_kv_heads:
        raise NotImplementedError("head padding is not ported yet")
    L, D, H, Hkv, Dh, F = (n_layers, cfg.d_model, cfg.num_heads,
                           cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)

    def ones():
        return torch.ones((L, D), dtype=dtype, device=gen.device)

    attn = {"wq": dense_init(gen, (L, D, H, Dh), D, dtype),
            "wk": dense_init(gen, (L, D, Hkv, Dh), D, dtype),
            "wv": dense_init(gen, (L, D, Hkv, Dh), D, dtype),
            "wo": dense_init(gen, (L, H, Dh, D), H * Dh, dtype)}
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((L, Dh), dtype=dtype, device=gen.device)
        attn["k_norm"] = torch.ones((L, Dh), dtype=dtype, device=gen.device)
    ffn = {"up": dense_init(gen, (L, D, F), D, dtype),
           "down": dense_init(gen, (L, F, D), F, dtype)}
    if cfg.mlp_type == "glu":
        ffn["gate"] = dense_init(gen, (L, D, F), D, dtype)
    return {"ln1": {"scale": ones()}, "attn": attn, "ln2": {"scale": ones()},
            "ffn": ffn}


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter tree (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def decode_block(cfg: ModelConfig, p, x, cache, pos, *, impl: Impl,
                 use_rope: bool = True):
    """One dense block for one new token; updates ``cache`` in place.
    Returns (x, cache)."""
    h, cache = attn_mod.decode_attn(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                                    cache, pos, use_rope=use_rope,
                                    impl=impl.decode_attention)
    x = x + h
    h = apply_mlp(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x))
    return x + h, cache


def decode_stack(cfg: ModelConfig, stacked, caches, x, pos, *, impl: Impl,
                 use_rope: bool = True):
    """Walk the layer stack for one new token; the stacked caches
    ({"k", "v"} of (L, B, S, Hkv, Dh)) are updated in place."""
    for i in range(caches["k"].shape[0]):
        x, _ = decode_block(cfg, layer(stacked, i), x,
                            {"k": caches["k"][i], "v": caches["v"][i]}, pos,
                            impl=impl, use_rope=use_rope)
    return x, caches
