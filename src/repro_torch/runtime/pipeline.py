"""Pipeline parallelism: a GPipe schedule over MPKLink stage-handoff
channels (the port of ``repro.runtime.pipeline``).

The layers are split into contiguous stages, one a rank of the channel's
group. At each tick every stage runs its layers on one microbatch and
pushes the activation to its successor through the guarded channel: stage
s and stage s + 1 are co-located services exchanging one message a tick
over a pre-established channel. The schedule takes n_micro + n_stages − 1
ticks (the GPipe bubble). Every hop is differentiable (the backward of a
shift is the opposite shift), so autograd through ``pipeline_apply`` is
the GPipe backward.

Dense and VLM blocks only, as the reference (an MoE stage would nest
expert parallelism; compose ``models.moe_ep`` per stage for that).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.domains import DomainKey
from repro_torch.core.fabric import (FabricChannel, MPKLinkFabric, _all_reduce,
                                     axis_size, neighbor_exchange)
from repro_torch.models.transformer import Impl, apply_block, layers
from repro_torch.tree import map_tree


class _BroadcastFrom(torch.autograd.Function):
    """Sum-broadcast ``x`` from group rank ``src`` to every rank, with the
    true adjoint spelled out: the cotangent is masked back to ``src``, not
    summed (the loss is computed on every rank's copy of the output, and
    only one copy is the output)."""

    @staticmethod
    def forward(ctx, group, src, x):
        ctx.mine = dist.get_rank(group) == src
        return _all_reduce(x if ctx.mine else torch.zeros_like(x), group)

    @staticmethod
    def backward(ctx, ct):
        return None, None, ct if ctx.mine else torch.zeros_like(ct)


def pipeline_apply(cfg: ModelConfig, local_params, x_micro, *,
                   fabric: MPKLinkFabric, chan: FabricChannel, key: DomainKey,
                   impl: Impl) -> Tuple[torch.Tensor, torch.Tensor]:
    """Called in every rank of the stage channel's group.

    local_params: this stage's block stack, leading dim L / n_stages
    (``stage_split(stacked, n)`` indexed by the rank). x_micro (n_micro,
    mb, S, D), the same in every rank (stage 0 consumes it). → (outputs
    (n_micro, mb, S, D), valid in every rank after a broadcast from the
    last stage; ok)."""
    fabric.check(chan, key)
    if cfg.moe:
        raise ValueError("pipeline stages compose with moe_ep, not a dense MoE")
    group = fabric.group(chan)
    n = axis_size(group)
    first = torch.tensor(dist.get_rank(group) == 0, device=x_micro.device)
    blocks = layers(local_params)
    n_micro, mb, S, D = x_micro.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x_micro.device)[None].expand(mb, S)
    held = torch.zeros((mb, S, D), dtype=x_micro.dtype, device=x_micro.device)
    ok = torch.ones((), dtype=torch.int32, device=x_micro.device)
    emits = []
    for t in range(n_micro + n - 1):
        # stage 0 injects microbatch t (clipped; its outputs past n_micro are
        # never read). A tensor select, not a branch: every rank's graph has
        # the same hops, so every backward hop has its peer
        h = torch.where(first, x_micro[min(t, n_micro - 1)], held)
        for p in blocks:
            h, _ = apply_block(cfg, p, h, positions=positions, impl=impl)
        emits.append(h)
        # guarded push to the next stage (ring wrap: stage 0 ignores what
        # the last stage sends back; it injects instead)
        held, ok_i = neighbor_exchange(fabric, chan, key, h, shift=1)
        ok = ok & ok_i
    # microbatch m leaves the last stage at tick m + n - 1
    outs = torch.stack(emits[n - 1:])
    return _BroadcastFrom.apply(group, n - 1, outs), ok


def stage_split(stacked_params, n_stages: int):
    """A (L, ...) block stack → (n_stages, L / n_stages, ...) (views); rank s
    takes index s."""
    def split(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return map_tree(split, stacked_params)
