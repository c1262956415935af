"""Expert-parallel MoE over an MPKLink all-to-all channel (the port of
``repro.models.moe_ep``).

The dense MoE (``models.moe``) runs every expert in one place. Expert
parallelism places ``le = E / ep`` experts on each rank of the channel's
group and moves TOKENS between ranks: a token batch leaves one service (a
rank), crosses the fabric through a pre-established channel, and returns.

    route locally → per-expert send slots (E, C, D), filled by index
      → all_to_all (E split over the ranks)          [channel]
      → the local experts run their FFN on the ep·C rows received
      → all_to_all back
      → combine locally, by gathers

Routing, slots and weights are ``models.moe``'s (no (T, E, C) one-hot),
so at equal capacity the result is the dense layer's with routing groups
of one rank's tokens (``moe.group_size`` = those tokens).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.domains import DomainKey
from repro_torch.core.fabric import (FabricChannel, MPKLinkFabric, all_to_all,
                                     axis_size)
from repro_torch.models.moe import _route, combine, dispatch, expert_ffn


def apply_moe_ep(cfg: ModelConfig, local_weights, x_local, *,
                 fabric: MPKLinkFabric, chan: FabricChannel, key: DomainKey,
                 min_capacity: int = 1) -> Tuple[torch.Tensor, dict]:
    """Called in every rank of the channel's group.

    local_weights: {"router" (D, E) the same in every rank, "gate" / "up"
    (le, D, F) and "down" (le, F, D): this rank's experts, rank r holding
    experts r·le … (r+1)·le − 1}. x_local (B_loc, S, D) → (out (B_loc, S,
    D), aux of this rank's tokens)."""
    fabric.check(chan, key)
    ep = axis_size(fabric.group(chan))
    E = cfg.moe.num_experts
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} ranks")
    B, S, D = x_local.shape
    xf = x_local.reshape(B * S, D)
    route, aux = _route(cfg, local_weights, xf, min_capacity)
    send, flat = dispatch(route, xf, E)                          # (E, C, D)
    recv = all_to_all(fabric, chan, key, send, split_axis=0, concat_axis=1)
    # recv (le, ep·C, D): the rows for this rank's experts, by source rank
    out_e = expert_ffn(cfg, local_weights, recv)
    back = all_to_all(fabric, chan, key, out_e, split_axis=1, concat_axis=0)
    # back (E, C, D) in the original slot layout
    return combine(route, flat, back).reshape(B, S, D), aux


def split_expert_weights(weights, ep: int, rank: int):
    """Dense MoE weights → rank ``rank``'s expert-parallel slice of ``ep``:
    the router whole, the experts ``rank·le … (rank+1)·le − 1`` (views)."""
    E = weights["gate"].shape[0]
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} ranks")
    le = E // ep
    part = slice(rank * le, (rank + 1) * le)
    return {"router": weights["router"], "gate": weights["gate"][part],
            "up": weights["up"][part], "down": weights["down"][part]}
