"""AdamW on nested-dict trees (the port of ``repro.optim.adamw``):
decoupled weight decay, bias correction, global-norm clipping, cosine
schedule with linear warmup.

State mirrors the parameters: {"m", "v"} trees of ``dtype`` moments and
"step", an int32 scalar on the parameters' device. The update math is f32
whatever the moment dtype. Unlike the reference's pure function,
:func:`adamw_update` updates the parameters and moments in place (under
``torch.no_grad()``): at full width a second copy of the f32 parameters
and moments would cost ~15 GB of device memory. Weight decay follows the
reference exactly: it is applied to every leaf with more than one
dimension, which includes the stacked (L, D) norm scales.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.tree import leaves, map_tree


def init_opt_state(params, dtype=torch.float32) -> dict:
    """Zero moments of ``dtype`` shaped like ``params``; step 0."""
    device = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def cosine_lr(step, cfg: OptimizerConfig) -> float:
    """The learning rate at ``step`` (an int or int tensor), in f32
    arithmetic as the reference computes it."""
    f = np.float32
    s = f(int(step))
    warm = np.minimum(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    t = np.clip((s - f(cfg.warmup_steps))
                / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t))
    frac = f(cfg.min_lr_ratio) + f(1 - cfg.min_lr_ratio) * cos
    return float(f(cfg.lr) * warm * frac)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor)."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm: float):
    """→ (grads scaled to at most ``max_norm`` in global norm, the norm
    before clipping). New tensors; ``grads`` is left as it is."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return map_tree(lambda x: (x.float() * scale).to(x.dtype), grads), g


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptimizerConfig) -> Tuple[dict, dict, dict]:
    """One AdamW step → (params, state, metrics {"lr", "grad_norm"}).
    ``params`` and the moments in ``state`` are updated in place and
    returned; decay is not applied to 1-D leaves (norm scales of one layer,
    biases). Gradients are clipped leaf by leaf with the global scale."""
    state["step"] += 1
    step = int(state["step"])
    lr = cosine_lr(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = float(1.0 - np.float32(b1) ** np.float32(step))
    c2 = float(1.0 - np.float32(b2) ** np.float32(step))
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g = (g.float() * scale).to(g.dtype).float()
        m32 = m.float().mul_(b1).add_(g, alpha=1 - b1)
        v32 = v.float().mul_(b2).add_(g.square_(), alpha=1 - b2)
        delta = (m32 / c1).div_((v32 / c2).sqrt_().add_(cfg.eps))
        if p.ndim > 1:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_(p.float().sub_(delta, alpha=lr))
        m.copy_(m32)
        v.copy_(v32)
    return params, state, {"lr": lr, "grad_norm": gnorm}
