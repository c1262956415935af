"""Plain AdamW as the configurations state it: global-norm clipping,
bias-corrected moments, weight decay decoupled and scaled by the learning
rate on every leaf of more than one dimension, and a cosine schedule after
a linear warm-up. Float32 throughout."""
from __future__ import annotations

import math

import torch


def lr_at(step: int, opt: dict) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * frac


@torch.no_grad()
def step(params, grads, m, v, step_no: int, opt: dict) -> float:
    """One update of the lists ``params`` in place from ``grads``; the
    moments ``m``, ``v`` likewise. → the gradients' global norm before
    clipping."""
    gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2 for g in grads))
    scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-12))
    lr = lr_at(step_no, opt)
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** step_no, 1 - b2 ** step_no
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * scale
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (mi / c1) / ((vi / c2).sqrt() + opt["eps"])
        if p.ndim > 1:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
    return gnorm
