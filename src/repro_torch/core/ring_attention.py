"""Ring attention: sequence parallelism over an MPKLink channel (the port
of ``repro.core.ring_attention``).

q, k and v are split along the sequence over the channel's group. Each of
the n ring steps computes the local flash partial (out, lse) against the
resident K/V block, then passes the block and its positions to the next
rank through the guarded channel; after n steps every query block has
attended to the whole sequence while a rank held 1/n of K/V at a time.
The partials merge by the log-sum-exp rule.

The partial is ``kernels.ops.attention_lse``: the flash kernel with its
log-sum-exp on CUDA tensors, its plain version on the CPU. The kernel
masks ragged tiles, so nothing is padded (the reference pads to its
chunks, and its ``q_chunk`` / ``kv_chunk`` have no counterpart here).
Forward only, as the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.domains import DomainKey
from repro_torch.core.fabric import (FabricChannel, MPKLinkFabric, axis_size,
                                     neighbor_exchange)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF


def _merge(out1, lse1, out2, lse2):
    """Combine two attention partials over the same queries (f32)."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    denom = torch.clamp(w1 + w2, min=1e-30)
    out = (out1 * w1[..., None] + out2 * w2[..., None]) / denom[..., None]
    lse = torch.where(m > NEG_INF / 2, m_safe + torch.log(denom),
                      torch.full_like(m, NEG_INF))
    return out, lse


def ring_attention(fabric: MPKLinkFabric, chan: FabricChannel, key: DomainKey,
                   q, k, v, q_pos, kv_pos, *, causal: bool = True,
                   window: Optional[int] = None):
    """Called in every rank of the channel's group with its sequence block:
    q (B, Sq_loc, H, Dh), k / v (B, Skv_loc, Hkv, Dh), positions (B, S*_loc)
    holding ABSOLUTE positions (so causal and window masks stay exact
    across blocks) → (out (B, Sq_loc, H, Dh) in q's dtype, ok)."""
    fabric.check(chan, key)
    n = axis_size(fabric.group(chan))
    qp = q_pos.to(torch.int32)
    kp = kv_pos.to(torch.int32)
    out, lse = ops.attention_lse(q, k, v, qp, kp, causal=causal, window=window)
    out = out.float()
    ok = torch.ones((), dtype=torch.int32, device=q.device)
    for _ in range(n - 1):
        k, ok1 = neighbor_exchange(fabric, chan, key, k, shift=1)
        v, ok2 = neighbor_exchange(fabric, chan, key, v, shift=1)
        kp, ok3 = neighbor_exchange(fabric, chan, key, kp, shift=1)
        o2, l2 = ops.attention_lse(q, k, v, qp, kp, causal=causal, window=window)
        out, lse = _merge(out, lse, o2.float(), l2)
        ok = ok & ok1 & ok2 & ok3
    out = torch.where((qp < 0)[:, :, None, None], torch.zeros_like(out), out)
    return out.to(q.dtype), ok
