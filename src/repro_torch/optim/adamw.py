"""AdamW on nested-dict trees (the port of ``repro.optim.adamw``):
decoupled weight decay, bias correction, global-norm clipping, cosine
schedule with linear warmup.

State mirrors the parameters: {"m", "v"} trees of ``dtype`` moments and
"step", an int32 scalar on the parameters' device. The update math is f32
whatever the parameter and moment dtypes. Unlike the reference's pure
function, :func:`adamw_update` updates the parameters and moments in place
(under ``torch.no_grad()``): at full width a second copy of the f32
parameters and moments would cost ~15 GB of device memory. Weight decay
follows the reference exactly: it is applied to every leaf with more than
one dimension, which includes the stacked (L, D) norm scales.

Every f32 temporary of the norm and the update covers one contiguous piece
of a leaf (``SLICE_ELEMS`` elements at most), never a whole leaf: with bf16
parameters and moments a leaf is widened to f32 piece by piece. The
update is elementwise, so its pieces give the bits of one pass over the
leaf. The clipped gradients stay f32 inside the update: the reference
rounds them back to the gradients' dtype, which its train step keeps f32
(a bf16 → f32 cast is exact), so the train step's bits are the
reference's whatever the gradients' dtype.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.tree import leaves, map_tree

# 32 M elements: one f32 temporary of the norm or the update is 128 MB at
# most (grok-1-314b's expert leaf of one layer is 1.61 G elements, 6.4 GB
# in f32)
SLICE_ELEMS = 1 << 25


def _pieces(t: torch.Tensor, n: int):
    """Contiguous pieces of ``t`` of at most ``n`` elements (views of its
    storage, so writes land in ``t``)."""
    return t.view(-1).split(n)


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


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares of a leaf in f32, widened piece by piece."""
    sums = [torch.sum(torch.square(piece.float()))
            for piece in _pieces(x.contiguous(), SLICE_ELEMS)]
    return sums[0] if len(sums) == 1 else torch.sum(torch.stack(sums))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor)."""
    return torch.sqrt(torch.sum(torch.stack([_sum_squares(x) for x in leaves(tree)])))


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
    biases). Gradients are clipped leaf by leaf with the global scale, in
    f32, over pieces of ``SLICE_ELEMS`` elements of each leaf."""
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
        decay = p.ndim > 1
        for pp, gp, mp, vp in zip(*(_pieces(t, SLICE_ELEMS)
                                    for t in (p, g.contiguous(), m, v))):
            gp = gp.float() * scale
            m32 = mp.float().mul_(b1).add_(gp, alpha=1 - b1)
            v32 = vp.float().mul_(b2).add_(gp.square_(), alpha=1 - b2)
            delta = (m32 / c1).div_((v32 / c2).sqrt_().add_(cfg.eps))
            if decay:
                delta.add_(pp.float(), alpha=cfg.weight_decay)
            pp.copy_(pp.float().sub_(delta, alpha=lr))
            mp.copy_(m32)
            vp.copy_(v32)
    return params, state, {"lr": lr, "grad_norm": gnorm}
