"""Blocks and layer stacks of every family (the port of
``repro.models.transformer``).

  dense/vlm : [attn → ffn] × L
  moe       : [attn → moe-ffn] × L (aux losses summed over the layers)
  ssm       : [mamba2] × L
  hybrid    : ([mamba2] × attn_every → shared attn/ffn block) × (L / attn_every)
  audio     : encoder [attn → ffn] × Le (non-causal, no RoPE),
              decoder [self → cross → ffn] × L (no RoPE)

Layer parameters are stacked on a leading L axis, as the reference's
``init_stack`` produces them; the hybrid family's attention block is one
block whose weights every insertion shares (autograd sums its gradient
over the insertions). The stacks walk the L axis with a Python loop (the
reference's ``lax.scan``). With ``Impl.remat`` each layer of a
full-sequence stack (each segment of the hybrid's) runs under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its scan
body: its activations are dropped after the forward and recomputed, through
the same kernels, in the backward. The full-sequence stacks return (x, aux)
as the reference's do: aux holds the MoE losses (``zero_aux``), and is
empty for the other families. The decode stacks update the stacked decode
state in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, apply_norm, dense_init, init_norm
from repro_torch.tree import leaves, map_tree

_IMPLS = ("kernel", "plain")


@dataclass(frozen=True)
class Impl:
    """Kernel selection for each kernel of the path. ``"kernel"`` routes
    through ``kernels.ops`` (the CUDA kernel for CUDA tensors, the plain
    version on the CPU); ``"plain"`` runs the plain PyTorch version on any
    device. ``attention`` is the full-sequence (prefill) attention,
    ``decode_attention`` the single-token one, ``ssd`` the Mamba2 scan.
    ``remat`` recomputes each layer's (each hybrid segment's) activations
    in the backward instead of keeping them (the reference's
    ``Impl.remat``; off by default, as the reference's ``Trainer`` runs):
    the forward kernels launch twice a layer under grad."""
    attention: str = "kernel"
    decode_attention: str = "kernel"
    ssd: str = "kernel"
    remat: bool = False

    def __post_init__(self):
        for name in ("attention", "decode_attention", "ssd"):
            if getattr(self, name) not in _IMPLS:
                raise ValueError(f"unknown {name} impl {getattr(self, name)!r}")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port does not run: a family outside
    the reference's ten architectures' (dense, vlm, moe, ssm, audio
    encoder-decoder, shared-attention hybrid), or a hybrid without a
    shared block."""
    if (cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
            or (cfg.family == "hybrid" and not cfg.shared_attn)
            or cfg.enc_dec != (cfg.family == "audio")):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense, VLM, MoE, SSM, "
            f"encoder-decoder and shared-attention hybrid families")


def zero_aux(cfg: ModelConfig, device) -> dict:
    """The aux losses a stack starts from: the MoE terms at 0, else {}."""
    if cfg.moe:
        return {k: torch.zeros((), device=device)
                for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")}
    return {}


def _add_aux(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def init_stack(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
               dtype=torch.float32) -> dict:
    """``n_layers`` blocks stacked on a leading L axis: the tree of the
    reference's ``init_stack`` (dense and moe: ln1, attn {wq, wk, wv, wo
    [, q_norm, k_norm]}, ln2, ffn {up, down, gate} or {router, gate, up,
    down}; ssm and hybrid: ln1, mamba). Norms are ``layers.init_norm``'s:
    empty for np_layernorm. An encoder-decoder's encoder is such a stack
    of attention blocks."""
    check_ported(cfg)
    if cfg.family not in ("ssm", "hybrid"):
        return _init_attn_blocks(cfg, gen, n_layers, dtype)
    return {"ln1": init_norm(cfg, (n_layers,), dtype, device=gen.device),
            "mamba": ssm_mod.init_mamba_stack(cfg, gen, n_layers, dtype)}


def init_shared_block(cfg: ModelConfig, gen: torch.Generator,
                      dtype=torch.float32) -> dict:
    """The hybrid family's one attention + MLP block (``shared_attn``:
    ln1, attn, ln2, ffn, unstacked), as the reference's ``init_params``."""
    return map_tree(lambda t: t[0].clone(), _init_attn_blocks(cfg, gen, 1, dtype))


def _init_attn(cfg: ModelConfig, gen: torch.Generator, L: int, dtype) -> dict:
    """wq (L, D, Hq, Dh), wk / wv (L, D, Hkv, Dh), wo (L, Hq, Dh, D) over
    the effective head counts. With head padding (``pad_q_heads`` /
    ``pad_kv_heads``, the reference's padded ``init_attn``) the real heads
    keep their (kv, j) place in the padded (kv_pad, g_pad) grid, and the
    pad rows of wq, wk, wv and wo are zero: pad kv heads give k = v = 0
    and pad q heads add exactly 0 to the output."""
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Hp, Hkvp = cfg.q_heads_eff, cfg.kv_heads_eff
    g, gp = H // Hkv, Hp // Hkvp
    if Hkvp < Hkv or gp < g or Hp % Hkvp:
        raise ValueError(f"{cfg.name}: cannot pad {H}/{Hkv} heads to {Hp}/{Hkvp}")

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=gen.device)
    wq, wo = zeros(L, D, Hkvp, gp, Dh), zeros(L, Hkvp, gp, Dh, D)
    wk, wv = zeros(L, D, Hkvp, Dh), zeros(L, D, Hkvp, Dh)
    wq[:, :, :Hkv, :g] = dense_init(gen, (L, D, Hkv, g, Dh), D, dtype)
    wk[:, :, :Hkv] = dense_init(gen, (L, D, Hkv, Dh), D, dtype)
    wv[:, :, :Hkv] = dense_init(gen, (L, D, Hkv, Dh), D, dtype)
    wo[:, :Hkv, :g] = dense_init(gen, (L, Hkv, g, Dh, D), H * Dh, dtype)
    attn = {"wq": wq.reshape(L, D, Hp, Dh), "wk": wk, "wv": wv,
            "wo": wo.reshape(L, Hp, Dh, D)}
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((L, Dh), dtype=dtype, device=gen.device)
        attn["k_norm"] = torch.ones((L, Dh), dtype=dtype, device=gen.device)
    return attn


def _init_attn_blocks(cfg: ModelConfig, gen: torch.Generator, L: int, dtype) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    attn = _init_attn(cfg, gen, L, dtype)
    if cfg.moe:
        ffn = moe_mod.init_moe_stack(cfg, gen, L, dtype)
    else:
        ffn = {"up": dense_init(gen, (L, D, F), D, dtype),
               "down": dense_init(gen, (L, F, D), F, dtype)}
        if cfg.mlp_type == "glu":
            ffn["gate"] = dense_init(gen, (L, D, F), D, dtype)
    return {"ln1": init_norm(cfg, (L,), dtype, device=gen.device), "attn": attn,
            "ln2": init_norm(cfg, (L,), dtype, device=gen.device), "ffn": ffn}


def init_dec_stack(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                   dtype=torch.float32) -> dict:
    """``n_layers`` decoder blocks of an encoder-decoder stacked on a
    leading L axis: the tree of the reference's ``init_dec_block`` (ln1,
    attn, ln2, cross, ln3, ffn; ``cross`` is an attention block of its
    own)."""
    p = _init_attn_blocks(cfg, gen, n_layers, dtype)
    p["cross"] = _init_attn(cfg, gen, n_layers, dtype)
    p["ln3"] = init_norm(cfg, (n_layers,), dtype, device=gen.device)
    return p


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter tree (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def layers(stacked: dict) -> list:
    """Every layer of a stacked parameter tree, as views from one
    ``unbind`` per leaf. Under autograd this matters: ``unbind``'s backward
    stacks the layers' gradients once, where ``L`` separate ``v[i]`` would
    each scatter a gradient into a zero tensor of the whole stack and sum
    ``L`` of them (O(L²) bytes a leaf)."""
    n = num_layers(stacked)

    def split(t):
        if isinstance(t, dict):
            parts = {k: split(v) for k, v in t.items()}
            return [{k: p[i] for k, p in parts.items()} for i in range(n)]
        return t.unbind(0)
    return split(stacked)


def num_layers(stacked: dict) -> int:
    """The L of a stacked tree, read from any leaf (a norm may have none)."""
    return leaves(stacked)[0].shape[0]


# ---------------------------------------------------------------------------
# full-sequence stacks (prefill)
# ---------------------------------------------------------------------------

def _mamba_block(cfg: ModelConfig, p, x, *, impl: Impl):
    return x + ssm_mod.apply_mamba(cfg, p["mamba"], apply_norm(cfg, p["ln1"], x),
                                   impl=impl.ssd)


def _ffn(cfg: ModelConfig, p, h):
    """The block's FFN → (out, aux): the MoE FFN where ``cfg.moe``, else
    the MLP with empty aux."""
    if cfg.moe:
        return moe_mod.apply_moe(cfg, p, h)
    return apply_mlp(cfg, p, h), {}


def _attn_block(cfg: ModelConfig, p, x, *, positions, impl: Impl,
                causal: bool = True, use_rope: bool = True):
    h = attn_mod.apply_attn(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                            positions=positions, causal=causal, use_rope=use_rope,
                            impl=impl.attention)
    x = x + h
    h, aux = _ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x))
    return x + h, aux


def apply_block(cfg: ModelConfig, p, x, *, positions, impl: Impl,
                causal: bool = True, use_rope: bool = True):
    """Full-sequence block → (x, aux); an attention block is causal with
    RoPE unless told otherwise (an encoder's is neither)."""
    if cfg.family == "ssm":
        return _mamba_block(cfg, p, x, impl=impl), {}
    return _attn_block(cfg, p, x, positions=positions, impl=impl, causal=causal,
                       use_rope=use_rope)


def _remat(impl: Impl, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``impl.remat`` is set and autograd records: what ``fn`` saves for its
    backward is dropped and recomputed when the backward reaches it. No RNG
    state is stashed: no forward of the port draws random numbers."""
    if impl.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def apply_stack(cfg: ModelConfig, stacked, x, *, positions, impl: Impl,
                causal: bool = True, use_rope: bool = True):
    """Walk the layer stack over a whole sequence → (x, aux summed over the
    layers)."""
    def block(p, x):
        return apply_block(cfg, p, x, positions=positions, impl=impl,
                           causal=causal, use_rope=use_rope)

    aux = zero_aux(cfg, x.device)
    for p in layers(stacked):
        x, aux_l = _remat(impl, block, p, x)
        aux = _add_aux(aux, aux_l)
    return x, aux


def apply_hybrid_stack(cfg: ModelConfig, mamba_stack, shared_block, x, *,
                       positions, impl: Impl):
    """zamba2: segments of ``attn_every`` mamba blocks, each followed by the
    shared attention + MLP block → (x, aux (empty))."""
    every = cfg.attn_every
    blocks = layers(mamba_stack)
    if len(blocks) % every:
        raise ValueError(f"{cfg.name}: {len(blocks)} layers do not split into "
                         f"segments of {every}")

    def segment(segment_blocks, x):
        for p in segment_blocks:
            x = _mamba_block(cfg, p, x, impl=impl)
        return _attn_block(cfg, shared_block, x, positions=positions, impl=impl)[0]

    for i in range(0, len(blocks), every):
        x = _remat(impl, segment, blocks[i:i + every], x)
    return x, zero_aux(cfg, x.device)


# ---------------------------------------------------------------------------
# decode (one new token through the cached stack)
# ---------------------------------------------------------------------------

def _decode_mamba_block(cfg: ModelConfig, p, x, cache):
    h, new = ssm_mod.decode_mamba(cfg, p["mamba"], apply_norm(cfg, p["ln1"], x),
                                  cache)
    cache["conv"].copy_(new["conv"])
    cache["ssd"].copy_(new["ssd"])
    return x + h, cache


def _decode_attn_block(cfg: ModelConfig, p, x, cache, pos, *, impl: Impl,
                       use_rope: bool = True):
    h, cache = attn_mod.decode_attn(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                                    cache, pos, use_rope=use_rope,
                                    impl=impl.decode_attention)
    x = x + h
    h, _ = _ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x))
    return x + h, cache


def decode_block(cfg: ModelConfig, p, x, cache, pos, *, impl: Impl,
                 use_rope: bool = True):
    """One block for one new token; updates ``cache`` (one layer's views of
    the stacked decode state) in place. Returns (x, cache)."""
    if cfg.family == "ssm":
        return _decode_mamba_block(cfg, p, x, cache)
    return _decode_attn_block(cfg, p, x, cache, pos, impl=impl, use_rope=use_rope)


def decode_stack(cfg: ModelConfig, stacked, caches, x, pos, *, impl: Impl,
                 use_rope: bool = True):
    """Walk the layer stack for one new token; the stacked decode state
    (dense: {"k", "v"} of (L, B, S, Hkv, Dh); ssm: {"ssd", "conv"}) is
    updated in place."""
    for i in range(num_layers(stacked)):
        x, _ = decode_block(cfg, layer(stacked, i), x,
                            {k: c[i] for k, c in caches.items()}, pos,
                            impl=impl, use_rope=use_rope)
    return x, caches


def decode_hybrid_stack(cfg: ModelConfig, mamba_stack, shared_block, caches, x,
                        pos, *, impl: Impl):
    """One new token through the hybrid stack. ``caches`` is
    {"mamba": {"ssd", "conv"} stacked on L, "attn": {"k", "v"} stacked on
    L / attn_every, one KV cache per insertion of the shared block};
    updated in place."""
    every = cfg.attn_every
    for i in range(num_layers(mamba_stack)):
        x, _ = _decode_mamba_block(cfg, layer(mamba_stack, i), x,
                                   {k: c[i] for k, c in caches["mamba"].items()})
        if (i + 1) % every == 0:
            seg = {k: c[i // every] for k, c in caches["attn"].items()}
            x, _ = _decode_attn_block(cfg, shared_block, x, seg, pos, impl=impl)
    return x, caches


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)
# ---------------------------------------------------------------------------

def apply_dec_block(cfg: ModelConfig, p, x, enc_out, enc_pos, *, positions,
                    impl: Impl):
    """A decoder block over the whole sequence: causal self-attention
    without RoPE, cross-attention over ``enc_out``, the MLP."""
    h = attn_mod.apply_attn(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                            positions=positions, causal=True, use_rope=False,
                            impl=impl.attention)
    x = x + h
    h = attn_mod.apply_cross_attn(cfg, p["cross"], apply_norm(cfg, p["ln2"], x),
                                  enc_out, enc_pos, impl=impl.attention)
    x = x + h
    return x + apply_mlp(cfg, p["ffn"], apply_norm(cfg, p["ln3"], x))


def apply_dec_stack(cfg: ModelConfig, stacked, x, enc_out, *, positions,
                    impl: Impl):
    """Walk the decoder stack over a whole sequence against the encoder's
    output (B, Se, D) → (x, aux (empty))."""
    B, Se = enc_out.shape[:2]
    enc_pos = torch.arange(Se, dtype=torch.int32, device=x.device)[None].expand(B, Se)

    def block(p, x):
        return apply_dec_block(cfg, p, x, enc_out, enc_pos, positions=positions,
                               impl=impl)

    for p in layers(stacked):
        x = _remat(impl, block, p, x)
    return x, {}


def decode_dec_block(cfg: ModelConfig, p, x, cache, pos, *, impl: Impl):
    """One decoder block for one new token. ``cache`` = {"self": one
    layer's dense cache (updated in place), "cross": its encoder K/V}."""
    h, _ = attn_mod.decode_attn(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                                cache["self"], pos, use_rope=False,
                                impl=impl.decode_attention)
    x = x + h
    h, _ = attn_mod.decode_attn(cfg, p["cross"], apply_norm(cfg, p["ln2"], x),
                                cache["cross"], pos, cross=True,
                                impl=impl.decode_attention)
    x = x + h
    x = x + apply_mlp(cfg, p["ffn"], apply_norm(cfg, p["ln3"], x))
    return x, cache


def decode_dec_stack(cfg: ModelConfig, stacked, caches, x, pos, *, impl: Impl):
    """One new token through the decoder stack. ``caches`` = {"self":
    {"k", "v"} of (L, B, S, Hkv, Dh), "cross": {"k", "v"} of (L, B, Se,
    Hkv, Dh)}; the self caches are updated in place."""
    for i in range(num_layers(stacked)):
        x, _ = decode_dec_block(
            cfg, layer(stacked, i), x,
            {part: {k: c[i] for k, c in caches[part].items()}
             for part in ("self", "cross")}, pos, impl=impl)
    return x, caches
