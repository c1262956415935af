"""Core layers in PyTorch: norms, the GLU MLP, embeddings, RoPE (the port of
``repro.models.layers``).

Parameters are plain nested dicts of tensors, as the reference's pytrees;
every function is pure. Norms and RoPE compute in f32 and cast back, and
the LM head accumulates in f32, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

VOCAB_PAD = 128   # vocab padded to a multiple; pad logits are masked to -1e30


def padded_vocab(vocab_size: int) -> int:
    return ((vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


# The most elements one f32 draw of ``dense_init`` holds (1 GiB). A larger
# tensor is drawn in slices of its leading axes (a stack layer by layer,
# mixtral's experts a few at a time), each cast as it is drawn, so the f32
# temporary stays small beside the weights. Tensors up to this size are
# drawn whole, as before.
_DRAW_ELEMS = 1 << 28


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, drawn in f32 on the generator's
    device and cast to ``dtype`` (the reference's ``layers.dense_init``)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    _fill_trunc_normal(out, gen, 1.0 / max(1, fan_in) ** 0.5)
    return out


def _fill_trunc_normal(out: torch.Tensor, gen: torch.Generator, scale: float):
    if out.numel() > _DRAW_ELEMS and out.ndim > 1:
        row = out.numel() // out.shape[0]
        if row > _DRAW_ELEMS:
            for r in out:
                _fill_trunc_normal(r, gen, scale)
        else:
            per = _DRAW_ELEMS // row
            for i in range(0, out.shape[0], per):
                _fill_trunc_normal(out[i:i + per], gen, scale)
        return
    t = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out.copy_(t.mul_(scale))


def rms_norm(x: torch.Tensor, weight, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def np_layernorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale, no bias): the population
    variance in f32, cast back."""
    return layer_norm(x, None, None, eps)


def layer_norm(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def init_norm(cfg: ModelConfig, lead=(), dtype=torch.float32, *, device) -> dict:
    """A norm's parameters on ``device`` with leading axes ``lead``
    (``(L,)`` for a stack), as the reference's ``init_norm``: ``{}`` for
    np_layernorm, ``{"scale"}`` (ones) for rmsnorm, and ``{"scale",
    "bias"}`` (zeros) for layernorm."""
    if cfg.norm_type == "np_layernorm":
        return {}
    shape = (*lead, cfg.d_model)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def apply_norm(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, params["scale"], cfg.norm_eps)
    if cfg.norm_type == "np_layernorm":
        return np_layernorm(x, cfg.norm_eps)
    return layer_norm(x, params["scale"], params.get("bias"), cfg.norm_eps)


_ACTIVATIONS = {"silu": F.silu, "relu": F.relu,
                "gelu": lambda x: F.gelu(x, approximate="tanh")}


def apply_mlp(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    act = _ACTIVATIONS[cfg.act]
    up = x @ params["up"].to(x.dtype)
    if cfg.mlp_type == "glu":
        h = act(x @ params["gate"].to(x.dtype)) * up
    else:
        h = act(up)
    return h @ params["down"].to(x.dtype)


def embed_tokens(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["tok"][tokens].to(dtype)


class _HeadF32(torch.autograd.Function):
    """x (M, D) @ w (Vp, D)ᵀ in x's dtype with an f32 output: one product on
    the card (``torch.mm(..., out_dtype=f32)``, which has no backward of its
    own). The backward rounds the f32 logit gradient to x's dtype for its
    two products (f32 accumulation, outputs in x's dtype), as
    mixed-precision training does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w, g.T @ x


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """(..., D) → (..., Vp) f32 logits. The head is first rounded to x's
    dtype, as the reference rounds it, and the product accumulates and
    returns f32: on the card one bf16 product with an f32 output, with no
    f32 copy of the head (differentiable through :class:`_HeadF32`)."""
    w = params["tok"] if cfg.tie_embeddings else params["head"].T   # (Vp, D)
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        logits = x @ w.T
    elif x.device.type in ("cuda", "meta"):         # meta: the card's path, counted
        logits = _HeadF32.apply(x.reshape(-1, x.shape[-1]), w) \
            .reshape(*x.shape[:-1], -1)
    else:
        logits = x.float() @ w.float().T
    if logits.shape[-1] != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int → (cos, sin) of shape (..., head_dim // 2), f32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., n_heads, head_dim); cos/sin broadcastable (..., 1, head_dim//2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
