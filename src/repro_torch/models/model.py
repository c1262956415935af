"""Top-level model API: init / forward / loss / decode state / decode step
for the dense, MoE, SSM and hybrid families (the port of that subset of
``repro.models.model``).

The parameter tree is the reference's: ``{"embed": {"tok" (Vp, D)[,
"head"]}, "final_norm": <norm>, "blocks": <stacked blocks>}``, and for
the hybrid family also ``"shared_attn"`` {ln1, attn, ln2, ffn}, so
``convert.params_from_numpy`` can carry the JAX package's parameters over.
A norm is ``{"scale"}`` (rmsnorm), ``{"scale", "bias"}`` (layernorm) or
``{}`` (np_layernorm).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import kvcache
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (apply_norm, dense_init, embed_tokens,
                                       init_norm, lm_logits, padded_vocab)
from repro_torch.models.transformer import Impl


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                dtype=torch.float32) -> dict:
    """Random parameters drawn from ``gen`` on its device, with the
    reference's distributions (``model.init_params``): embeddings
    N(0, 0.02²), dense weights truncated-normal fan-in, norm scales 1, and
    the Mamba2 init of ``ssm.init_mamba_stack``; norms as
    ``layers.init_norm``."""
    tf.check_ported(cfg)
    vp, D = padded_vocab(cfg.vocab_size), cfg.d_model
    tok = torch.empty((vp, D), dtype=torch.float32, device=gen.device)
    embed = {"tok": torch.nn.init.normal_(tok, 0.0, 0.02, generator=gen).to(dtype)}
    if not cfg.tie_embeddings:
        embed["head"] = dense_init(gen, (D, vp), D, dtype)
    params = {"embed": embed,
              "final_norm": init_norm(cfg, (), dtype, gen.device),
              "blocks": tf.init_stack(cfg, gen, cfg.num_layers, dtype)}
    if cfg.family == "hybrid":
        params["shared_attn"] = tf.init_shared_block(cfg, gen, dtype)
    return params


def forward(cfg: ModelConfig, params, batch, *, impl: Impl = Impl(),
            dtype=torch.bfloat16, last_only: bool = False):
    """``batch["tokens"]`` (B, S) int → (logits (B, S, Vp) f32, aux dict),
    as the reference returns them; aux holds the MoE losses summed over the
    layers (``moe_lb_loss``, ``moe_z_loss``, ``moe_drop_frac``) and is
    empty for the other families. ``last_only`` computes logits for the final
    position only (serving prefill: the next-token head is all a prefill
    needs, and it keeps the (B, S, V) tensor out of memory). Text input
    only."""
    tf.check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    x = embed_tokens(params["embed"], tokens, dtype)
    if cfg.family == "hybrid":
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


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      dtype=torch.bfloat16, device="cuda") -> dict:
    """``{"caches": ..., "pos": 0}``: dense KV caches {"k", "v"} of
    (L, B, S, Hkv, Dh); for the SSM family the recurrent state
    {"ssd" (L, B, H, P, N) f32, "conv" (L, B, cw-1, C)}; for the hybrid
    family {"mamba": that state, "attn": KV caches of (L / attn_every, B,
    S, Hkv, Dh)}, one per insertion of the shared block. A sliding window
    needs no ring cache while ``max_seq <= swa_window`` (the reference's
    ``_attn_cache_spec`` then takes a dense cache); past the window it
    would, and ring caches are not ported yet, so that raises."""
    tf.check_ported(cfg)
    if cfg.swa_window is not None and max_seq > cfg.swa_window:
        raise NotImplementedError(
            f"{cfg.name}: max_seq {max_seq} exceeds the sliding window "
            f"{cfg.swa_window}, which needs a ring cache (not ported yet)")
    dev = resolve(device)
    s = cfg.ssm
    if cfg.family in ("ssm", "hybrid"):
        caches = kvcache.init_ssm_state(
            cfg.num_layers, batch, cfg.ssm_heads, s.head_dim, s.d_state,
            s.conv_width, cfg.d_inner + 2 * s.n_groups * s.d_state, dtype, dev)
        if cfg.family == "hybrid":
            caches = {"mamba": caches, "attn": kvcache.init_dense_cache(
                cfg.num_layers // cfg.attn_every, batch, max_seq,
                cfg.kv_heads_eff, cfg.head_dim, dtype, dev)}
    else:
        caches = kvcache.init_dense_cache(cfg.num_layers, batch, max_seq,
                                          cfg.kv_heads_eff, cfg.head_dim, dtype,
                                          dev)
    return {"caches": caches, "pos": 0}


def decode_step(cfg: ModelConfig, params, state, token: torch.Tensor, *,
                impl: Impl = Impl(), dtype=torch.bfloat16):
    """token (B,1) int at position state["pos"] (an int, or a (B,) tensor
    of per-slot positions) → (logits (B,1,Vp) f32, state). The caches in
    ``state`` are updated in place; the returned state holds pos + 1."""
    pos = state["pos"]
    x = embed_tokens(params["embed"], token, dtype)
    if cfg.family == "hybrid":
        x, caches = tf.decode_hybrid_stack(cfg, params["blocks"],
                                           params["shared_attn"], state["caches"],
                                           x, pos, impl=impl)
    else:
        x, caches = tf.decode_stack(cfg, params["blocks"], state["caches"], x,
                                    pos, impl=impl)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_logits(cfg, params["embed"], x)
    return logits, {"caches": caches, "pos": pos + 1}
