"""Mamba2 block: fused in-projection, depthwise causal conv, SSD core, gated
RMS norm, out-projection (the port of ``repro.models.ssm``).

Layout follows the Mamba2 reference: one in_proj produces
  [z (d_inner) | xBC (d_inner + 2·G·N) | dt (H)]
with the short causal conv applied to the xBC slab only. The SSD core is
``kernels.ops.ssd`` (the CUDA kernel for CUDA tensors, its plain version on
the CPU) or, with ``impl="plain"``, the plain version on any device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import ssd_decode_step, ssd_scan_plain
from repro_torch.models.layers import dense_init, rms_norm

_SSD_IMPLS = {"kernel": kops.ssd, "plain": ssd_scan_plain}


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = cfg.d_inner
    H = cfg.ssm_heads
    conv_ch = di + 2 * s.n_groups * s.d_state
    return s, di, H, conv_ch


def init_mamba_stack(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                     dtype=torch.float32) -> dict:
    """``n_layers`` Mamba2 blocks stacked on a leading L axis, with the
    reference's distributions (``ssm.init_mamba``): dt_bias is the inverse
    softplus of dt drawn log-uniform in [dt_min, dt_max], A_log = log(1..H),
    D = 1. dt_bias, A_log and D stay f32 whatever ``dtype`` is, as the
    reference keeps them (they enter the f32 SSD arithmetic)."""
    s, di, H, conv_ch = _dims(cfg)
    L, D = n_layers, cfg.d_model
    dev = gen.device
    proj_out = 2 * di + 2 * s.n_groups * s.d_state + H
    u = torch.rand((L, H), generator=gen, device=dev)
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt0 = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))          # inverse softplus
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev))
    return {
        "in_proj": dense_init(gen, (L, D, proj_out), D, dtype),
        "conv_w": dense_init(gen, (L, s.conv_width, conv_ch), s.conv_width, dtype),
        "conv_b": torch.zeros((L, conv_ch), dtype=dtype, device=dev),
        "dt_bias": dt_bias,
        "A_log": a_log.expand(L, H).contiguous(),
        "D": torch.ones((L, H), device=dev),
        "gate_norm": torch.ones((L, di), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (L, di, D), di, dtype),
    }


def _causal_conv(w, b, x: torch.Tensor, state=None):
    """Depthwise causal conv, width cw. x (B,S,C); state (B,cw-1,C) or None.
    Returns (y (B,S,C), new_state)."""
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(cw))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(cw - 1):] if cw > 1 else state
    return y, new_state


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, di, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn],
            zxbcdt[..., 2 * di + 2 * gn:])


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    s, di, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def apply_mamba(cfg: ModelConfig, p, x: torch.Tensor, *, impl: str = "kernel"):
    """Full-sequence Mamba2 block (prefill, state discarded)."""
    y, _ = apply_mamba_with_state(cfg, p, x, conv_state=None, ssd_state=None,
                                  impl=impl)
    return y


def apply_mamba_with_state(cfg: ModelConfig, p, x: torch.Tensor, *, conv_state,
                           ssd_state, impl: str = "kernel"):
    """x (B,S,D) → (out (B,S,D), {"conv", "ssd"} states after the sequence)."""
    s, di, H, _ = _dims(cfg)
    B, S, _ = x.shape
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc, new_conv = _causal_conv(p["conv_w"], p["conv_b"], xbc, conv_state)
    xbc = F.silu(xbc)
    xs, Bm, Cm = _split_xbc(cfg, xbc)

    dt = F.softplus(dt.float() + p["dt_bias"].float())              # (B,S,H)
    xh = xs.reshape(B, S, H, s.head_dim).contiguous()
    Bh = Bm.reshape(B, S, s.n_groups, s.d_state).contiguous()
    Ch = Cm.reshape(B, S, s.n_groups, s.d_state).contiguous()
    y, final_state = _SSD_IMPLS[impl](xh, dt, p["A_log"].float(), Bh, Ch,
                                      p["D"].float(), ssd_state,
                                      chunk=s.chunk_size)
    y = rms_norm(y.reshape(B, S, di) * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"conv": new_conv, "ssd": final_state}


def decode_mamba(cfg: ModelConfig, p, x_new: torch.Tensor, state: dict):
    """Single-token recurrent step. x_new (B,1,D); state {"conv", "ssd"}.
    → (out (B,1,D), {"conv", "ssd"} new states)."""
    s, di, H, _ = _dims(cfg)
    B = x_new.shape[0]
    zxbcdt = x_new @ p["in_proj"].to(x_new.dtype)
    z, xbc, dt = _split_proj(cfg, zxbcdt)

    # conv state: (B, cw-1, C) rolling window
    xp = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)      # (B,cw,C)
    y = sum(xp[:, i:i + 1] * p["conv_w"][i].to(xbc.dtype)
            for i in range(s.conv_width))
    xbc = F.silu(y + p["conv_b"].to(xbc.dtype))
    new_conv = xp[:, 1:]

    xs, Bm, Cm = _split_xbc(cfg, xbc)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())        # (B,H)
    y_t, new_ssd = ssd_decode_step(
        xs[:, 0].reshape(B, H, s.head_dim), dt, p["A_log"],
        Bm[:, 0].reshape(B, s.n_groups, s.d_state),
        Cm[:, 0].reshape(B, s.n_groups, s.d_state), p["D"], state["ssd"])
    y_t = rms_norm(y_t.reshape(B, 1, di) * F.silu(z), p["gate_norm"],
                   cfg.norm_eps)
    out = y_t @ p["out_proj"].to(x_new.dtype)
    return out, {"conv": new_conv, "ssd": new_ssd}
