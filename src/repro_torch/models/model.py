"""Top-level model API: init / forward / loss / decode state / decode step
for all ten architectures' families (the port of ``repro.models.model``).

The parameter tree is the reference's: ``{"embed": {"tok" (Vp, D)[,
"head"]}, "final_norm": <norm>, "blocks": <stacked blocks>}``; the hybrid
family adds ``"shared_attn"`` {ln1, attn, ln2, ffn}; an encoder-decoder's
``"blocks"`` are decoder blocks {ln1, attn, ln2, cross, ln3, ffn} and it
adds ``"enc_blocks"`` and ``"enc_final_norm"``; a VLM adds
``"vision_proj"`` {w (vision_dim, D), b (D,)}. So
``convert.params_from_numpy`` can carry the JAX package's parameters over.
A norm is ``{"scale"}`` (rmsnorm), ``{"scale", "bias"}`` (layernorm) or
``{}`` (np_layernorm).

Batches: ``{"tokens" (B, S), "labels" (B, S)}``, plus for a VLM
``"vision_embeds"`` (B, vision_tokens, vision_dim), which replace the
first vision_tokens positions, and for an encoder-decoder ``"frames"``
(B, enc_ctx, D), the encoder's input.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import kvcache
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (apply_norm, dense_init, embed_tokens,
                                       init_norm, lm_logits, padded_vocab)
from repro_torch.models.transformer import Impl


def sinusoid(seq_len: int, d_model: int, offset=0, *, device="cuda") -> torch.Tensor:
    """(seq_len, d_model) f32 sinusoidal positions [sin | cos] from
    ``offset`` on, as the reference's ``sinusoid``; the angles are built
    in f32 (a bf16 angle at position 1499 would be off by radians)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    ang = pos[:, None] * _freqs(d_model, pos.device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _freqs(d_model: int, device) -> torch.Tensor:
    half = d_model // 2
    return torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=device) / half)


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                dtype=torch.float32) -> dict:
    """Random parameters drawn from ``gen`` on its device, with the
    reference's distributions (``model.init_params``): embeddings
    N(0, 0.02²), dense weights truncated-normal fan-in, norm scales 1, and
    the Mamba2 init of ``ssm.init_mamba_stack``; norms as
    ``layers.init_norm``; a VLM's ``vision_proj`` bias 0."""
    tf.check_ported(cfg)
    vp, D = padded_vocab(cfg.vocab_size), cfg.d_model
    tok = torch.empty((vp, D), dtype=torch.float32, device=gen.device)
    embed = {"tok": torch.nn.init.normal_(tok, 0.0, 0.02, generator=gen).to(dtype)}
    if not cfg.tie_embeddings:
        embed["head"] = dense_init(gen, (D, vp), D, dtype)
    params = {"embed": embed, "final_norm": init_norm(cfg, (), dtype, device=gen.device)}
    if cfg.enc_dec:
        params["enc_blocks"] = tf.init_stack(cfg, gen, cfg.enc_layers, dtype)
        params["blocks"] = tf.init_dec_stack(cfg, gen, cfg.num_layers, dtype)
        params["enc_final_norm"] = init_norm(cfg, (), dtype, device=gen.device)
    else:
        params["blocks"] = tf.init_stack(cfg, gen, cfg.num_layers, dtype)
    if cfg.family == "hybrid":
        params["shared_attn"] = tf.init_shared_block(cfg, gen, dtype)
    if cfg.vision_tokens:
        params["vision_proj"] = {
            "w": dense_init(gen, (cfg.vision_dim, D), cfg.vision_dim, dtype),
            "b": torch.zeros((D,), dtype=dtype, device=gen.device)}
    return params


def _embed_input(cfg: ModelConfig, params, batch, dtype) -> torch.Tensor:
    """Token embeddings (B, S, D); for a VLM batch with ``vision_embeds``
    the projected patches take the first ``vision_tokens`` positions."""
    x = embed_tokens(params["embed"], batch["tokens"], dtype)
    if cfg.vision_tokens and "vision_embeds" in batch:
        vp = params["vision_proj"]
        v = batch["vision_embeds"].to(dtype) @ vp["w"].to(dtype) + vp["b"].to(dtype)
        x = torch.cat([v, x[:, cfg.vision_tokens:]], dim=1)
    return x


def encode(cfg: ModelConfig, params, frames: torch.Tensor, *,
           impl: Impl = Impl()) -> torch.Tensor:
    """The audio encoder: frame embeddings (B, Se, D) (the frontend is a
    stub) plus the sinusoid, through the encoder stack (non-causal, no
    RoPE) and its final norm → (B, Se, D)."""
    B, Se, D = frames.shape
    x = frames + sinusoid(Se, D, device=frames.device).to(frames.dtype)[None]
    positions = torch.arange(Se, dtype=torch.int32,
                             device=frames.device)[None].expand(B, Se)
    x, _ = tf.apply_stack(cfg, params["enc_blocks"], x, positions=positions,
                          impl=impl, causal=False, use_rope=False)
    return apply_norm(cfg, params["enc_final_norm"], x)


def forward(cfg: ModelConfig, params, batch, *, impl: Impl = Impl(),
            dtype=torch.bfloat16, last_only: bool = False):
    """``batch["tokens"]`` (B, S) int → (logits (B, S, Vp) f32, aux dict),
    as the reference returns them; aux holds the MoE losses summed over the
    layers (``moe_lb_loss``, ``moe_z_loss``, ``moe_drop_frac``) and is
    empty for the other families. ``last_only`` computes logits for the final
    position only (serving prefill: the next-token head is all a prefill
    needs, and it keeps the (B, S, V) tensor out of memory). A VLM takes
    ``batch["vision_embeds"]``, an encoder-decoder ``batch["frames"]``."""
    tf.check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    x = _embed_input(cfg, params, batch, dtype)
    if cfg.enc_dec:
        enc_out = encode(cfg, params, batch["frames"].to(dtype), impl=impl)
        x = x + sinusoid(S, cfg.d_model, device=x.device).to(dtype)[None]
        x, aux = tf.apply_dec_stack(cfg, params["blocks"], x, enc_out,
                                    positions=positions, impl=impl)
    elif cfg.family == "hybrid":
        x, aux = tf.apply_hybrid_stack(cfg, params["blocks"], params["shared_attn"],
                                       x, positions=positions, impl=impl)
    else:
        x, aux = tf.apply_stack(cfg, params["blocks"], x, positions=positions,
                                impl=impl)
    if last_only:
        x = x[:, -1:]
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params["embed"], x), aux


def loss_fn(cfg: ModelConfig, params, batch, *, impl: Impl = Impl(),
            dtype=torch.bfloat16):
    """Next-token cross entropy over ``batch["tokens"]`` / ``batch["labels"]``
    (B, S), labels == -1 masked, averaged over the unmasked targets, plus
    the MoE aux losses ``moe_lb_loss`` and ``moe_z_loss`` →
    (loss, metrics {"ce", **aux, "loss"}), as the reference's ``loss_fn``.
    The logits are f32; position S - 1 predicts nothing (its target is set
    to -1 rather than sliced off, so the (B, S, Vp) logits are not
    copied)."""
    logits, aux = forward(cfg, params, batch, impl=impl, dtype=dtype)
    labels = batch["labels"].long()
    targets = torch.full_like(labels, -1)
    targets[:, :-1] = torch.where(labels[:, 1:] >= 0, labels[:, 1:], -1)
    n = (targets >= 0).sum()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                         ignore_index=-1, reduction="sum") / n.clamp(min=1)
    loss = ce
    for k in ("moe_lb_loss", "moe_z_loss"):
        if k in aux:
            loss = loss + aux[k]
    return loss, {"ce": ce, **aux, "loss": loss}


def _attn_cache_spec(cfg: ModelConfig, n_layers: int, batch: int, max_seq: int,
                     dtype, device) -> dict:
    """The reference's ``_attn_cache_spec`` for a stack of ``n_layers``: a
    ring cache of ``swa_window`` slots when the config has a window and
    ``max_seq`` passes it, else a dense cache of ``max_seq``."""
    if cfg.swa_window is not None and max_seq > cfg.swa_window:
        return kvcache.init_ring_cache(n_layers, batch, cfg.swa_window,
                                       cfg.kv_heads_eff, cfg.head_dim, dtype, device)
    return kvcache.init_dense_cache(n_layers, batch, max_seq, cfg.kv_heads_eff,
                                    cfg.head_dim, dtype, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      dtype=torch.bfloat16, device="cuda", params=None,
                      enc_out=None) -> dict:
    """``{"caches": ..., "pos": 0}``: KV caches {"k", "v"} of (L, B, S,
    Hkv, Dh), or, for a window shorter than ``max_seq``, ring caches of
    its W slots with "slot_pos" (L, W); for the SSM family the recurrent
    state {"ssd" (L, B, H, P, N) f32, "conv" (L, B, cw-1, C)}; for the
    hybrid family {"mamba": that state, "attn": KV caches of one layer per
    insertion of the shared block}. An encoder-decoder needs ``params``
    and the encoder's output ``enc_out`` (B, Se, D) (``encode``): its
    caches are {"self": dense caches, "cross": {"k", "v"} of (L, B, Se,
    Hkv, Dh)}, each layer's cross K/V projected once from ``enc_out``, in
    its dtype and on its device."""
    tf.check_ported(cfg)
    dev = resolve(device)
    s = cfg.ssm
    if cfg.family in ("ssm", "hybrid"):
        caches = kvcache.init_ssm_state(
            cfg.num_layers, batch, cfg.ssm_heads, s.head_dim, s.d_state,
            s.conv_width, cfg.d_inner + 2 * s.n_groups * s.d_state, dtype, dev)
        if cfg.family == "hybrid":
            caches = {"mamba": caches, "attn": _attn_cache_spec(
                cfg, cfg.num_layers // cfg.attn_every, batch, max_seq, dtype, dev)}
    elif cfg.enc_dec:
        if params is None or enc_out is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder decode state needs "
                             f"params= and the encoder's output enc_out=")
        cross = params["blocks"]["cross"]

        def project(w):             # (L, D, Hkv, Dh) → (L, B, Se, Hkv, Dh)
            return torch.stack([
                (enc_out @ w_l.to(enc_out.dtype).reshape(cfg.d_model, -1))
                .reshape(*enc_out.shape[:2], *w_l.shape[1:]) for w_l in w])
        caches = {"self": kvcache.init_dense_cache(
                      cfg.num_layers, batch, max_seq, cfg.kv_heads_eff,
                      cfg.head_dim, dtype, dev),
                  "cross": {"k": project(cross["wk"]), "v": project(cross["wv"])}}
    else:
        caches = _attn_cache_spec(cfg, cfg.num_layers, batch, max_seq, dtype, dev)
    return {"caches": caches, "pos": 0}


def decode_step(cfg: ModelConfig, params, state, token: torch.Tensor, *,
                impl: Impl = Impl(), dtype=torch.bfloat16):
    """token (B,1) int at position state["pos"] (an int, or a (B,) tensor
    of per-slot positions) → (logits (B,1,Vp) f32, state). The caches in
    ``state`` are updated in place; the returned state holds pos + 1. An
    encoder-decoder adds the sinusoid at ``pos`` and attends over the
    state's cross K/V; a VLM decodes text (no vision prefix)."""
    pos = state["pos"]
    x = embed_tokens(params["embed"], token, dtype)
    if cfg.enc_dec:
        p = (pos.to(device=x.device, dtype=torch.float32)
             if isinstance(pos, torch.Tensor) else      # a fill, no host copy
             torch.full((), float(pos), dtype=torch.float32, device=x.device))
        ang = p[..., None] * _freqs(cfg.d_model, x.device)        # (half,) or (B, half)
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        x = x + (pe[None, None] if pe.ndim == 1 else pe[:, None]).to(dtype)
        x, caches = tf.decode_dec_stack(cfg, params["blocks"], state["caches"], x,
                                        pos, impl=impl)
    elif cfg.family == "hybrid":
        x, caches = tf.decode_hybrid_stack(cfg, params["blocks"],
                                           params["shared_attn"], state["caches"],
                                           x, pos, impl=impl)
    else:
        x, caches = tf.decode_stack(cfg, params["blocks"], state["caches"], x,
                                    pos, impl=impl)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_logits(cfg, params["embed"], x)
    return logits, {"caches": caches, "pos": pos + 1}
