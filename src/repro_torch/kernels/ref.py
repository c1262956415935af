"""Plain PyTorch oracles for the ported kernels. Slow, obvious, and correct.

The torch counterpart of ``repro.kernels.ref``: attention, the SSD
recurrence and the guard MAC. The hand-written CUDA kernels must match
these bit for bit (MACs) or within the stated tolerance (attention, SSD),
and the CPU tests hold these against the JAX reference.

Conventions (as in the reference)
---------------------------------
attention: q (B, Sq, H, Dh); k, v (B, Skv, Hkv, Dh) with H = Hkv * g (GQA).
positions: q_pos (B, Sq), kv_pos (B, Skv) int32; kv_pos == -1 marks an
invalid slot (unfilled cache / padding), q_pos < 0 marks a padded query row
(output forced to 0). ``causal`` masks kv_pos > q_pos; ``window`` (if set)
masks q_pos - kv_pos >= window (SWA).

ssd: x (B, S, H, P); dt (B, S, H); A_log, D (H,); B, C (B, S, G, N) shared
by the H // G heads of a group; state (B, H, P, N) f32.

guard MAC: payload (n, 128) uint32; 128-lane Horner hash seeded with
h0 = INIT + tag (``h = h·P + row``), folded to one word by Σ h_i·P^(127-i).

Integer arithmetic: torch on the CPU cannot add ``uint32`` tensors and
``.sum()`` of ``uint32`` widens to int64 without wrapping, so every MAC
quantity here is an int64 holding a value below 2^32, masked with
``& 0xFFFFFFFF`` after every multiply, add and sum. Products of two such
values would overflow int64, so :func:`mul32` splits one factor in 16-bit
halves.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

NEG_INF = -1e30
MAC_PRIME = 0x01000193   # FNV-ish multiplier
MAC_INIT = 0x811C9DC5
LANES = 128
MASK32 = 0xFFFFFFFF


def _fold_powers_u32() -> np.ndarray:
    """PRIME^(127-i) mod 2^32 — Horner across lanes as one vector dot."""
    out = np.zeros(LANES, np.uint64)
    acc = 1
    for i in range(LANES - 1, -1, -1):
        out[i] = acc
        acc = (acc * MAC_PRIME) & MASK32
    return out.astype(np.uint32)


FOLD_POWERS = _fold_powers_u32()
FOLD_POWERS.setflags(write=False)


@functools.lru_cache(maxsize=64)
def row_powers(n: int) -> Tuple[torch.Tensor, int]:
    """``([P^(n-1), ..., P, 1] mod 2^32 as a CPU int64 tensor, P^n mod
    2^32)`` for an n-row block (cached per n; do not write to it)."""
    with np.errstate(over="ignore"):
        pw = np.full(max(n, 1), MAC_PRIME, np.uint64)
        pw[0] = 1
        pw = np.cumprod(pw)[::-1][:n] & np.uint64(MASK32)
    return torch.from_numpy(pw.astype(np.int64)), pow(MAC_PRIME, n, 1 << 32)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a · b) mod 2^32 for int64 tensors (or an int ``b``) whose values
    are below 2^32, without overflowing int64."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def horner_rows(x: torch.Tensor) -> torch.Tensor:
    """Σ_r x_r·P^(n-1-r) mod 2^32 over the row axis of an int64
    (..., n, 128) tensor → (..., 128) int64 (0 for n = 0)."""
    n = x.shape[-2]
    pw = row_powers(n)[0].to(x.device)
    return mul32(x, pw[:, None]).sum(-2) & MASK32


def fold_lanes(h: torch.Tensor) -> torch.Tensor:
    """Σ_l h_l·P^(127-l) mod 2^32 over the last (lane) axis → int64."""
    fp = torch.from_numpy(FOLD_POWERS.astype(np.int64)).to(h.device)
    return mul32(h, fp).sum(-1) & MASK32


def mac_state(payload_u32: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Advance int64 Horner states h (..., 128) over (..., n, 128) rows:
    h·P^n + Σ_r row_r·P^(n-1-r) (mod 2^32)."""
    _, p_n = row_powers(payload_u32.shape[-2])
    return (mul32(h, p_n) + horner_rows(payload_u32.to(torch.int64))) & MASK32


def mac_ref(payload_u32: torch.Tensor, tag: int) -> torch.Tensor:
    """Folded 128-lane Horner MAC of an (n, 128) uint32 payload, seeded
    with ``tag`` → () int64 holding the uint32 word."""
    if payload_u32.dtype != torch.uint32 or payload_u32.shape[-1] != LANES:
        raise ValueError("mac_ref takes an (n, 128) uint32 payload")
    h0 = torch.full((LANES,), (MAC_INIT + tag) & MASK32, dtype=torch.int64,
                    device=payload_u32.device)
    return fold_lanes(mac_state(payload_u32, h0))


def guard_copy_ref(payload_u32: torch.Tensor, tag: int, expected_mac: int):
    """(copy, mac (1,) uint32, ok (1,) int32) — the receive-side guard."""
    mac = mac_ref(payload_u32, tag).reshape(1)
    ok = (mac == (expected_mac & MASK32)).to(torch.int32)
    return payload_u32.clone(), mac.to(torch.uint32), ok


def attention_ref(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                  window=None, softmax_scale=None):
    """Masked GQA attention in f32, output in q's dtype."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = softmax_scale if softmax_scale is not None else Dh ** -0.5

    qf = q.float().reshape(B, Sq, Hkv, g, Dh)
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale

    qp = q_pos[:, None, None, :, None].to(torch.int32)
    kp = kv_pos[:, None, None, None, :].to(torch.int32)
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        valid = valid & ((qp - kp) < window)
    scores = torch.where(valid, scores, torch.tensor(NEG_INF, device=q.device))

    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - torch.clamp(m, min=NEG_INF / 2))
    e = torch.where(valid, e, torch.zeros((), device=q.device))
    denom = e.sum(-1, keepdim=True)
    p = e / torch.clamp(denom, min=1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf).reshape(B, Sq, H, Dh)
    out = torch.where(q_pos[:, :, None, None] < 0,
                      torch.zeros((), device=q.device), out)
    return out.to(q.dtype)


def ssd_ref(x, dt, A_log, B, C, D, init_state=None):
    """The Mamba2 SSD as the sequential recurrence, one step at a time in
    f32: S_t = exp(dt_t·A)·S_{t-1} + dt_t·x_t ⊗ B_t, y_t = S_t·C_t + D·x_t
    with A = -exp(A_log). → (y in x's dtype, final state (B,H,P,N) f32)."""
    Bb, S, H, P = x.shape
    rep = H // B.shape[2]
    xf = x.float()
    dtf = dt.float()
    Bf = B.float().repeat_interleave(rep, dim=2)          # (B, S, H, N)
    Cf = C.float().repeat_interleave(rep, dim=2)
    A = -torch.exp(A_log.float())
    a = torch.exp(dtf * A[None, None, :])                 # (B, S, H) in (0, 1]
    state = (torch.zeros((Bb, H, P, B.shape[3]), device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        state = a[:, t, :, None, None] * state + torch.einsum(
            "bhp,bhn->bhpn", dtf[:, t, :, None] * xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), state
