"""Step functions: train (microbatched gradient accumulation + AdamW),
prefill and decode (the port of ``repro.runtime.steps``).

There is no mesh: the reference's ``dp`` and ``grad_specs`` shard the
microbatch and the gradient accumulator over devices, which one card does
not have (``launch.dryrun`` places them when it counts a step on a mesh).
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import decode_step, forward, loss_fn
from repro_torch.models.transformer import Impl
from repro_torch.optim import adamw_update
from repro_torch.tree import leaves, unflatten_like

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def train_grad_dtype(param_dtype: torch.dtype, n_micro: int) -> torch.dtype:
    """The dtype a train step keeps its gradients in: one microbatch's stay
    in the parameters' dtype, a sum of more is f32."""
    return param_dtype if n_micro == 1 else torch.float32


def _microbatch(v, i: int, n_micro: int):
    """Microbatch i of n_micro of a batch field: rows i·r … (i+1)·r."""
    r = v.shape[0] // n_micro
    return v[i * r:(i + 1) * r]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, impl: Impl = Impl()):
    """→ train_step(params, opt_state, batch) → (params, opt_state, metrics).

    The global batch (``batch["tokens"]`` / ``["labels"]``, (B, S), and a
    VLM's ``"vision_embeds"`` or an encoder-decoder's ``"frames"``) is split
    into B // micro microbatches of ``tcfg.microbatch_size`` rows (B must
    split evenly, as the reference's reshape demands); the gradients of
    each microbatch's loss (compute in ``tcfg.dtype``) are summed in f32
    and divided by their count, and one ``adamw_update`` follows. With one
    microbatch a step the gradients stay in the parameters' dtype
    (``train_grad_dtype``) and the update widens them to f32 piece by
    piece: the reference's f32 sum of one term divided by 1 is that exact
    widening, and a full f32 copy of bf16 gradients would not fit beside
    grok-1-314b's layer. The
    parameters require grad for the step only (each leaf's flag is put
    back as the step found it, so serving a trained state builds no
    graph) and are updated in place; metrics are {"loss" (mean over
    microbatches), "lr", "grad_norm"}. The forward, backward and optimizer of each call
    are ``torch.profiler`` ranges (``train_step.forward`` / ``.backward``
    / ``.optimizer``, ``tracing.phase``), and spans of the same names while
    the span recorder is armed (forward and backward with their ``micro``
    index); the f32 gradient sum of each microbatch after the first is
    the span ``train_step.accumulate`` (its ``micro``)."""
    dtype = DTYPES[tcfg.dtype]
    micro = tcfg.microbatch_size

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        n_micro = max(1, B // micro)
        if B % n_micro:
            raise ValueError(f"train_step: a batch of {B} rows does not split "
                             f"into {n_micro} microbatches of {micro}")
        flat = leaves(params)
        found = [p.requires_grad for p in flat]
        for p in flat:
            p.requires_grad_(True)
        try:
            gsum, loss_sum = None, None
            for i in range(n_micro):
                mb = {k: _microbatch(v, i, n_micro) for k, v in batch.items()}
                with tracing.phase("train_step.forward", micro=i):
                    loss, _ = loss_fn(cfg, params, mb, impl=impl, dtype=dtype)
                with tracing.phase("train_step.backward", micro=i):
                    grads = torch.autograd.grad(loss, flat,
                                                materialize_grads=True)
                if gsum is None:
                    gsum = [g.to(train_grad_dtype(p.dtype, n_micro))
                            for p, g in zip(flat, grads)]
                else:
                    with tracing.span("train_step.accumulate") as sp:
                        if sp:
                            sp.set(micro=i)
                        for a, g in zip(gsum, grads):
                            a.add_(g.float())
                loss_sum = loss.detach() if loss_sum is None \
                    else loss_sum + loss.detach()
                del loss, grads
        finally:
            for p, r in zip(flat, found):
                p.requires_grad_(r)
        with tracing.phase("train_step.optimizer"):
            if n_micro > 1:
                gsum = [g.div_(n_micro) for g in gsum]
            params, opt_state, om = adamw_update(
                params, unflatten_like(params, gsum), opt_state, tcfg.optimizer)
        return params, opt_state, {"loss": loss_sum / n_micro, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, impl: Impl = Impl(),
                      dtype=torch.bfloat16):
    """Serving prefill: full-context forward, next-token logits only, under
    ``no_grad`` (a parameter that requires grad builds no graph).
    → prefill_step(params, {"tokens": (B, S)[, "vision_embeds", "frames"]})
    → logits (B, 1, Vp) f32; a VLM's patch embeddings and an
    encoder-decoder's frames are carried to ``models.forward``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = forward(cfg, params, batch, impl=impl, dtype=dtype,
                            last_only=True)
        return logits
    return prefill_step


def make_decode_step(cfg: ModelConfig, impl: Impl = Impl(),
                     dtype=torch.bfloat16):
    """Serving decode: one token through the cached stack, under
    ``no_grad`` (an encoder-decoder's state holds its cross K/V, built by
    ``init_decode_state(..., params=, enc_out=)``).
    → serve_step(params, state, token (B, 1)) → (logits (B, 1, Vp), state)."""
    @torch.no_grad()
    def serve_step(params, state, token):
        return decode_step(cfg, params, state, token, impl=impl, dtype=dtype)
    return serve_step
