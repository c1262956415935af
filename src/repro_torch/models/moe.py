"""Top-k routed mixture-of-experts FFN (the port of ``repro.models.moe``).

The routing is the reference's: router logits in x's dtype, softmax in
f32, top-k renormalised, and capacity queues filled choice-major (every
token's first choice before any second choice) in flattened (b, s) order;
a (token, choice) pair past its expert's capacity
``C = max(min_capacity, int(capacity_factor · T · k / E))`` is dropped and
adds 0. Aux losses: the Switch load balance (from first choices) and the
router z-loss, and the share of pairs dropped.

Where the reference dispatches and combines through dense (T, E, C)
one-hot einsums, the port gathers: each kept pair's token row is copied
to its slot of an (E·C, D) expert input, and each token sums its kept
slots' outputs times their weights. The same pairs, slots and weights,
without the T·E·C tensors (1.5 GB a layer in f32 for mixtral's prefill of
2 × 6144 tokens). The expert products are batched matmuls over (E, C, D).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _ACTIVATIONS, dense_init


def init_moe_stack(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                   dtype=torch.float32) -> dict:
    """``n_layers`` MoE FFNs stacked on a leading L axis: router (L, D, E);
    gate and up (L, E, D, F); down (L, E, F, D), as the reference's
    ``init_moe`` under ``init_stack``."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    L = n_layers
    return {"router": dense_init(gen, (L, D, E), D, dtype),
            "gate": dense_init(gen, (L, E, D, F_), D, dtype),
            "up": dense_init(gen, (L, E, D, F_), D, dtype),
            "down": dense_init(gen, (L, E, F_, D), F_, dtype)}


def capacity(cfg: ModelConfig, T: int, min_capacity: int = 1) -> int:
    m = cfg.moe
    return max(min_capacity, int(m.capacity_factor * T * m.top_k / m.num_experts))


def _route(cfg: ModelConfig, p, x_flat: torch.Tensor, min_capacity: int = 1):
    """x_flat (T, D) → (route, aux). ``route`` holds, for every (token,
    choice) pair, (T, k) tensors: ``expert``, ``slot`` (its place in the
    expert's queue), ``keep`` (slot < C) and ``weight`` (the renormalised
    probability, 0 where dropped), and ``capacity`` C. The reference's
    dispatch is 1 at [t, expert, slot] of each kept pair, its combine the
    weight there."""
    m = cfg.moe
    T = x_flat.shape[0]
    E, k = m.num_experts, m.top_k
    C = capacity(cfg, T, min_capacity)

    logits = (x_flat @ p["router"].to(x_flat.dtype)).float()            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k by a stable sort: equal probabilities keep the lower expert
    # first, as jax.lax.top_k orders them
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    # choice-major queues: each choice's pairs queue in token order after
    # every pair of the choices before it, dropped ones included
    fill = torch.zeros(E, dtype=torch.int64, device=x_flat.device)
    slots = []
    for j in range(k):
        onehot = F.one_hot(top_e[:, j], E)                                # (T, E)
        before = torch.cumsum(onehot, 0) - onehot + fill
        slots.append(before.gather(1, top_e[:, j:j + 1])[:, 0])
        fill = fill + onehot.sum(0)
    slot = torch.stack(slots, dim=1)                                      # (T, k)
    keep = slot < C

    frac_tokens = F.one_hot(top_e[:, 0], E).float().mean(0)
    lb = E * torch.sum(frac_tokens * probs.mean(0)) * m.load_balance_loss
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_loss
    dropped = 1.0 - keep.sum().float() / (T * k)
    route = {"expert": top_e, "slot": slot, "keep": keep,
             "weight": top_p * keep, "capacity": C}
    return route, {"moe_lb_loss": lb, "moe_z_loss": z, "moe_drop_frac": dropped}


def dispatch(route: dict, xf: torch.Tensor, n_experts: int):
    """One routing group's expert input: each kept (token, choice) pair's
    row of xf (T, D) copied to its slot → ((E, C, D) input, (T, k) flat
    slots). A dropped pair's flat slot is 0: it is combined with weight 0
    and writes nowhere. Every pair is copied, a dropped one to a spare row
    past the E·C slots that is cut off, so no shape depends on the routing
    (no host sync, and a meta-device trace runs it)."""
    C = route["capacity"]
    keep = route["keep"]
    flat = route["expert"] * C + torch.where(keep, route["slot"], 0)
    dest = torch.where(keep, flat, n_experts * C).reshape(-1)
    token = torch.arange(xf.shape[0], device=xf.device).repeat_interleave(
        keep.shape[1])
    expert_in = xf.new_zeros((n_experts * C + 1, xf.shape[-1])).index_copy(
        0, dest, xf[token])[:n_experts * C]
    return expert_in.view(n_experts, C, xf.shape[-1]), flat


def expert_ffn(cfg: ModelConfig, p, expert_in: torch.Tensor) -> torch.Tensor:
    """The experts' gated FFNs over their rows: (E, R, D) → (E, R, D), with
    p's gate / up (E, D, F) and down (E, F, D) in the input's dtype."""
    act = _ACTIVATIONS[cfg.act]
    h = act(torch.bmm(expert_in, p["gate"].to(expert_in.dtype)))
    h = h * torch.bmm(expert_in, p["up"].to(expert_in.dtype))
    return torch.bmm(h, p["down"].to(expert_in.dtype))


def combine(route: dict, flat: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Each token's kept slots of the (E, C, D) expert output, summed with
    their weights in f32 → (T, D) in the output's dtype."""
    out = out.reshape(-1, out.shape[-1])
    w = route["weight"].to(out.dtype)
    y = sum(out[flat[:, j]].float() * w[:, j:j + 1].float()
            for j in range(flat.shape[1]))
    return y.to(out.dtype)


def _moe_ffn_flat(cfg: ModelConfig, p, xf: torch.Tensor, min_capacity: int = 1
                  ) -> Tuple[torch.Tensor, dict]:
    """One routing group: xf (T, D) → (out (T, D), aux)."""
    route, aux = _route(cfg, p, xf, min_capacity)
    expert_in, flat = dispatch(route, xf, cfg.moe.num_experts)
    return combine(route, flat, expert_ffn(cfg, p, expert_in)), aux


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """x (B, S, D) → (out (B, S, D), aux). A decode step (S == 1) never
    drops: its capacity covers every token. With ``moe.group_size`` set
    and more tokens than a group, tokens route in independent groups of
    that size (GShard) and aux is the mean over groups."""
    B, S, D = x.shape
    T = B * S
    min_cap = T if S == 1 else 1
    g = cfg.moe.group_size
    if not g or T <= g:
        y, aux = _moe_ffn_flat(cfg, p, x.reshape(T, D), min_cap)
        return y.reshape(B, S, D), aux
    if T % g:
        raise ValueError(f"{T} tokens do not split into groups of {g}")
    outs, auxes = zip(*(_moe_ffn_flat(cfg, p, xg) for xg in x.reshape(T // g, g, D)))
    aux = {key: torch.stack([a[key] for a in auxes]).mean() for key in auxes[0]}
    return torch.stack(outs).reshape(B, S, D), aux
