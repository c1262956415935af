"""The Mamba2 SSD scan: CUDA kernel, its plain version, and the decode step.

The port of ``repro.kernels.ssd_scan`` and ``repro.kernels.ssd_jnp``. Inputs
as ``ref.ssd_ref``: x (B, S, H, P) in f32 or bf16, dt (B, S, H) f32, A_log
and D (H,) f32, B and C (B, S, G, N) shared by the H // G heads of a group,
init_state (B, H, P, N) f32 or None. Returns y in x's dtype and the final
state (B, H, P, N) in f32.

:func:`ssd_scan_cuda` launches ``csrc/ssd_scan.cu``. In bf16 that is three
chunk-parallel kernels on the tensor cores (chunk states, the state pass,
the output; :func:`bf16_launches`), with the chunk states as f32 scratch;
in f32 it is one block per (b, h) walking its chunks in order on the CUDA
cores. A ragged last chunk is masked in the kernels.
:func:`ssd_scan_plain` is ``ssd_jnp.ssd_chunked`` with two changes:

- the intra-chunk exponent is masked before ``exp``
  (``exp(where(i >= j, cum_i - cum_j, -inf))``), so every factor is at
  most 1. The reference takes exp over the whole Q×Q square and multiplies
  by ``tril`` afterwards, which overflows to ``inf·0 = NaN`` once a chunk's
  summed decay passes ~88 (mamba2-1.3b's own init reaches it);
- the in-chunk prefix sum ``cum`` of dt·A is taken in f64 and its
  differences are rounded to f32 before ``exp``. With mamba2's decays cum
  reaches −1000s inside one chunk, where an f32 prefix sum keeps only
  ~1e-4 of absolute precision, and every decay factor inherits that as a
  relative error. The kernel does the same.
:func:`ssd_scan_bwd_cuda` is the backward (the port of JAX's autodiff
through ``ssd_chunked``), six launches (:func:`bwd_launches`; in bf16 its
chunk kernel takes a tile of heads a block, :func:`bwd_heads_per_tile`), and
:func:`ssd_scan_bwd_plain` its plain version by the same formulas.
:func:`ssd_decode_step` is the one-token recurrence, plain PyTorch as in the
reference. ``kernels.ops`` picks the scan by the tensor's device and counts
the launches; ``ops.SSDScan`` differentiates through it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 128   # each a multiple of 32 in the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ssd_scan_f32": (_P,) * 9 + (_I,) * 7 + (_P,),
    "ssd_scan_bf16_cuda_cores": (_P,) * 9 + (_I,) * 7 + (_P,),
    "ssd_bf16_states": (_P,) * 6 + (_I,) * 7 + (_P,),
    "ssd_bf16_pass": (_P,) * 4 + (_I,) * 6 + (_P,),
    "ssd_bf16_output": (_P,) * 8 + (_I,) * 7 + (_P,),
    "ssd_bf16_dstates": (_P,) * 5 + (_I,) * 7 + (_P,),
    "ssd_f32_states": (_P,) * 6 + (_I,) * 7 + (_P,),
    "ssd_f32_dstates": (_P,) * 5 + (_I,) * 7 + (_P,),
    "ssd_bwd_pass": (_P,) * 4 + (_I,) * 6 + (_P,),
    "ssd_f64_walk": (_P,) * 4 + (_I,) * 7 + (_P,),
    "ssd_bwd_bf16": (_P,) * 15 + (_I,) * 8 + (_P,),
    "ssd_bwd_bf16_per_head": (_P,) * 15 + (_I,) * 7 + (_P,),
    "ssd_bwd_f32": (_P,) * 15 + (_I,) * 7 + (_P,),
    "ssd_bwd_finish_bf16": (_P,) * 9 + (_I,) * 7 + (_P,),
    "ssd_bwd_finish_f32": (_P,) * 9 + (_I,) * 7 + (_P,),
}
BWD_MAX_HEADS_PER_TILE = 8   # heads a block of the bf16 backward's chunk kernel takes at most


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 of ``t`` by ``pad`` steps (dt = 0: identity steps)."""
    if pad == 0:
        return t
    widths = [0, 0] * (t.ndim - 2) + [0, pad]
    return F.pad(t, widths)


def cost(x, dt, B, init_state=None, *, chunk: int = 128) -> dict:
    """The scan's work on x (Bb, S, H, P) with B/C (Bb, S, G, N): the
    chunked form's products, per chunk and head C·Bᵀ and att·x over the
    Q(Q+1)/2 causal pairs, the inter term and the state carry, in x's
    dtype; x, B, C, dt, A_log and D read once, y and the final f32 state
    written once (an init state read once)."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    Q, nc = chunk, -(-S // chunk)
    flops = 2 * Bb * H * nc * (Q * (Q + 1) // 2 * (N + P) + 2 * Q * N * P)
    state = Bb * H * P * N * 4
    nbytes = (2 * x.numel() + 2 * B.numel()) * x.element_size() \
        + dt.numel() * dt.element_size() + 2 * H * 4 + state \
        + (state if init_state is not None else 0)
    return {"flops": flops, "bytes": nbytes, "dtype": x.dtype}


def cost_bwd(x, dt, B, *, chunk: int = 128) -> dict:
    """The backward kernels' work: per chunk and head C·Bᵀ, dy·xᵀ and the
    three intra products over the Q(Q+1)/2 causal pairs, and five Q·N·P
    products (the recomputed chunk states, Σ exp(cum)·dy ⊗ C, and the carry
    and inter terms of dx, dB, dC), in x's dtype; x, dt, B, C, dy, A_log
    and D read once, dx, ddt, dB, dC, dA_log and dD written once."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    Q, nc = chunk, -(-S // chunk)
    flops = 2 * Bb * H * nc * (Q * (Q + 1) // 2 * (3 * N + 2 * P) + 5 * Q * N * P)
    nbytes = (2 * x.numel() + 4 * B.numel()) * x.element_size() \
        + 2 * dt.numel() * dt.element_size() + 4 * H * 4
    return {"flops": flops, "bytes": nbytes, "dtype": x.dtype}


def ssd_scan_plain(x, dt, A_log, B, C, D, init_state=None, *,
                   chunk: int = 128):
    """The chunked SSD in plain PyTorch, with the masked exponent."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    xf = _pad_seq(x.float(), pad)
    dtf = _pad_seq(dt.float(), pad)
    Bf = _pad_seq(B.float(), pad)
    Cf = _pad_seq(C.float(), pad)
    nc = xf.shape[1] // Q

    xb = xf.reshape(Bb, nc, Q, G, R, P)
    dtb = dtf.reshape(Bb, nc, Q, G, R)
    Bc = Bf.reshape(Bb, nc, Q, G, N)
    Cc = Cf.reshape(Bb, nc, Q, G, N)
    A = -torch.exp(A_log.float()).reshape(G, R)

    cum = torch.cumsum((dtb * A).double(), dim=2)        # (B,nc,Q,G,R) ≤ 0
    seg = cum[:, :, -1:]
    # intra-chunk: M_ij = exp(L_i − L_j) for i ≥ j, 0 above the diagonal
    diff = (cum[:, :, :, None] - cum[:, :, None]).float()   # (B,nc,Q,Q,G,R)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    dec = torch.exp(torch.where(tri[None, None, :, :, None, None], diff,
                                torch.tensor(float("-inf"), device=x.device)))
    cb = torch.einsum("bcqgn,bcjgn->bcqjg", Cc, Bc)
    att = cb[..., None] * dec * dtb[:, :, None]
    y_intra = torch.einsum("bcqjgr,bcjgrp->bcqgrp", att, xb)

    # chunk state contribution: Σ_j exp(L_Q − L_j)·dt_j·(x_j ⊗ B_j)
    w = torch.exp((seg - cum).float()) * dtb
    s_c = torch.einsum("bcjgrp,bcjgn->bcgrpn", w[..., None] * xb, Bc)

    state = (torch.zeros((Bb, G, R, P, N), device=x.device) if init_state is None
             else init_state.float().reshape(Bb, G, R, P, N))
    decay = torch.exp(seg[:, :, 0].float())              # (B,nc,G,R)
    states_in = []
    for c in range(nc):                                  # state entering chunk c
        states_in.append(state)
        state = decay[:, c, :, :, None, None] * state + s_c[:, c]
    states_in = torch.stack(states_in, dim=1)

    # inter-chunk: exp(L_i) · C_i · S_{c−1}
    y_inter = torch.einsum("bcqgn,bcgrpn,bcqgr->bcqgrp", Cc, states_in,
                           torch.exp(cum.float()))
    y = (y_intra + y_inter).reshape(Bb, nc * Q, H, P)[:, :S]
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state.reshape(Bb, H, P, N)


def ssd_scan_bwd_plain(x, dt, A_log, B, C, D, init_state, dy, dfinal=None, *,
                       chunk: int = 128):
    """The gradients of :func:`ssd_scan_plain` by explicit formulas (not
    autograd through it): dy the gradient of y, ``dfinal`` that of the
    final state or None (training drops it) → (dx, ddt, dA_log, dB, dC, dD,
    d init_state or None), each in its input's dtype.

    With cum the in-chunk prefix of dt·A (f64, as the forward), S_in[c] the
    state entering chunk c and G_ij = (C_i·B_j)·exp(cum_i − cum_j) masked to
    i ≥ j before the exp: a reverse pass over chunks gives dS[c], the
    gradient of the state leaving chunk c (dS[nc-1] = dfinal,
    dS[c-1] = exp(seg_c)·dS[c] + Σ_i exp(cum_i)·dy_i ⊗ C_i; d init_state is
    what reaches chunk 0's input). Per chunk, every product of the forward
    gives its operands' gradients, every exponential a term of d cum, and a
    reverse in-chunk cumsum of d cum gives d(dt·A), hence ddt and dA_log.
    dB and dC are summed over the H/G heads of a group."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    xf = _pad_seq(x.float(), pad)
    nc = xf.shape[1] // Q
    xb = xf.reshape(Bb, nc, Q, G, R, P)
    dyb = _pad_seq(dy.float(), pad).reshape(Bb, nc, Q, G, R, P)
    dtb = _pad_seq(dt.float(), pad).reshape(Bb, nc, Q, G, R)
    Bc = _pad_seq(B.float(), pad).reshape(Bb, nc, Q, G, N)
    Cc = _pad_seq(C.float(), pad).reshape(Bb, nc, Q, G, N)
    A = -torch.exp(A_log.float()).reshape(G, R)

    # the forward's pieces. ddt is a sum of parts that at mamba2's decays
    # are ~1e3 times larger than it (the direct term, x_j·dS·B_j and
    # A·d(dt·A), A up to 64), which take the rounding of every f32
    # intermediate to ~1e-3: its chain (C·B, dy·x, the decays, the chunk
    # states and dS, d cum, d(dt·A)) is carried in f64, the rest in f32
    f64 = torch.float64
    cum = torch.cumsum((dtb * A).double(), dim=2)        # (B,nc,Q,G,R)
    seg = cum[:, :, -1:]
    diff = cum[:, :, :, None] - cum[:, :, None]          # [i, j]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    dec64 = torch.exp(torch.where(tri[None, None, :, :, None, None], diff,
                                  torch.tensor(float("-inf"), dtype=f64,
                                               device=x.device)))
    dec = dec64.float()
    e_cum = torch.exp(cum)                               # exp(cum_i), f64
    e_rest = torch.exp(seg - cum)                        # exp(seg − cum_j), f64
    w = e_rest * dtb
    s_c = torch.einsum("bcjgrp,bcjgn->bcgrpn", w[..., None] * xb, Bc.double())
    decay = torch.exp(seg[:, :, 0])                      # (B,nc,G,R)
    state = (torch.zeros((Bb, G, R, P, N), dtype=f64, device=x.device)
             if init_state is None else init_state.double().reshape(Bb, G, R, P, N))
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = decay[:, c, :, :, None, None] * state + s_c[:, c]
    s_in = torch.stack(s_in, dim=1)                      # (B,nc,G,R,P,N)

    # (a) reverse state pass: ds_out[c] is the gradient of the state
    # leaving chunk c
    ds_c = torch.einsum("bcigrp,bcign->bcgrpn", e_cum[..., None] * dyb, Cc.double())
    g = (torch.zeros((Bb, G, R, P, N), dtype=f64, device=x.device) if dfinal is None
         else dfinal.double().reshape(Bb, G, R, P, N))
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = g
        g = decay[:, c, :, :, None, None] * g + ds_c[:, c]
    ds_out = torch.stack(ds_out, dim=1)
    d_init = None if init_state is None else g.reshape(Bb, H, P, N).float()
    s_in32, ds_out32, w32 = s_in.float(), ds_out.float(), w.float()

    # (b) per chunk. intra: y_i += Σ_j cb_ij·dec_ij·dt_j·x_j
    cb64 = torch.einsum("bcign,bcjgn->bcijg", Cc.double(), Bc.double())[..., None]
    dyx64 = torch.einsum("bcigrp,bcjgrp->bcijgr", dyb.double(), xb.double())
    cb, dt_j = cb64.float(), dtb[:, :, None]
    d_cb = dec * dt_j * dyx64.float()                    # d(C_i·B_j) per head
    dx = torch.einsum("bcijgr,bcigrp->bcjgrp", cb * dec * dt_j, dyb)
    dB = torch.einsum("bcijgr,bcign->bcjgn", d_cb, Cc)
    dC = torch.einsum("bcijgr,bcjgn->bcign", d_cb, Bc)
    t = cb64 * dec64 * dyx64
    ddt = t.sum(2)
    # each intra term T_ij enters d cum at i and, negated, at j; the reverse
    # cumsum below cancels every pair on one side of a step
    t = t * dt_j.double()
    d_cum = t.sum(3) - t.sum(2)
    # carry: S_out += w_j·x_j ⊗ B_j, w_j = exp(seg − cum_j)·dt_j
    r6 = torch.einsum("bcjgn,bcgrpn->bcjgrp", Bc, ds_out32)  # dS_out·B_j
    xr6 = torch.einsum("bcjgrp,bcjgn,bcgrpn->bcjgr", xb.double(), Bc.double(), ds_out)
    dx = dx + w32[..., None] * r6
    ddt = ddt + e_rest * xr6
    v = w * xr6
    dB = dB + torch.einsum("bcjgr,bcjgrp,bcgrpn->bcjgn", w32, xb, ds_out32)
    # inter: y_i += exp(cum_i)·S_in·C_i
    r8 = torch.einsum("bcigrp,bcgrpn->bcigrn", dyb, s_in32)
    dC = dC + torch.einsum("bcigr,bcigrn->bcign", e_cum.float(), r8)
    u = e_cum * torch.einsum("bcigrp,bcign,bcgrpn->bcigr", dyb.double(), Cc.double(),
                             s_in)
    d_cum = d_cum + u - v                                # V_j cancels against d seg too
    d_seg = v.sum(2) + decay * (ds_out * s_in).sum((-1, -2))
    d_cum[:, :, -1] += d_seg
    d_la = torch.flip(torch.cumsum(torch.flip(d_cum, [2]), 2), [2])
    ddt = (ddt + A.double() * d_la).float()
    dA = (dtb.double() * d_la).sum((0, 1, 2)).reshape(H)
    dx = dx.reshape(Bb, nc * Q, H, P)[:, :S] + D.float()[None, None, :, None] * dy.float()
    dD = (dy.float() * x.float()).sum((0, 1, 3))
    return (dx.to(x.dtype), ddt.reshape(Bb, nc * Q, H)[:, :S].to(dt.dtype),
            (A.reshape(H).double() * dA).to(A_log.dtype),
            dB.reshape(Bb, nc * Q, G, N)[:, :S].to(B.dtype),
            dC.reshape(Bb, nc * Q, G, N)[:, :S].to(C.dtype), dD.to(D.dtype), d_init)


def ssd_decode_step(x_t, dt_t, A_log, B_t, C_t, D, state):
    """Single-token recurrent step. x_t (B,H,P); dt_t (B,H); B_t/C_t (B,G,N);
    state (B,H,P,N) f32 → (y_t (B,H,P) in x_t's dtype, new_state)."""
    R = x_t.shape[1] // B_t.shape[1]
    xf = x_t.float()
    dtf = dt_t.float()
    A = -torch.exp(A_log.float())
    a = torch.exp(dtf * A[None])                                    # (B,H)
    Bh = B_t.float().repeat_interleave(R, dim=1)                    # (B,H,N)
    Ch = C_t.float().repeat_interleave(R, dim=1)
    state = a[:, :, None, None] * state + torch.einsum(
        "bhp,bhn->bhpn", dtf[..., None] * xf, Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) \
        + D.float()[None, :, None] * xf
    return y.to(x_t.dtype), state


def _validate(x, dt, A_log, B, C, D, init_state, chunk: int) -> None:
    """Raise for inputs the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: CUDA tensors required, got {x.device}")
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (S < 1 or G < 1 or H % G or dt.shape != (Bb, S, H)
            or B.shape != (Bb, S, G, N) or C.shape != B.shape
            or A_log.shape != (H,) or D.shape != (H,)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)} A_log {tuple(A_log.shape)} "
                         f"D {tuple(D.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or B.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: f32 or bf16 x/B/C of one dtype, got "
                         f"{x.dtype} {B.dtype} {C.dtype}")
    for name, t in (("dt", dt), ("A_log", A_log), ("D", D)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: {name} must be float32, got {t.dtype}")
    if P % 32 or P > MAX_P or N % 32 or N > MAX_N or chunk % 32 \
            or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: unsupported P={P} N={N} chunk={chunk} "
                         f"(multiples of 32, P <= {MAX_P}, N <= {MAX_N}, "
                         f"chunk <= {MAX_CHUNK})")
    inputs = [x, dt, A_log, B, C, D]
    if init_state is not None:
        if init_state.shape != (Bb, H, P, N) or init_state.dtype != torch.float32:
            raise ValueError(f"ssd_scan: init_state must be ({Bb}, {H}, {P}, "
                             f"{N}) float32")
        inputs.append(init_state)
    for t in inputs:
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("ssd_scan: contiguous inputs on one device")
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan: bf16 x/B/C must start 16-byte aligned "
                         "(the kernels load rows as 16-byte vectors)")


def _ptr(t):
    """A tensor's data pointer for ctypes; other values (None: NULL) as they
    are."""
    return t.data_ptr() if isinstance(t, torch.Tensor) else t


def bf16_launches(x, dt, A_log, B, C, D, init_state=None, *, chunk: int = 128):
    """The bf16 scan as its three kernel launches: → ((y, final state),
    [(name, launch), ...]). Running the launches in order on the current
    stream fills y and the final state; :func:`ssd_scan_cuda` does that, and
    each launch may also be timed alone."""
    _validate(x, dt, A_log, B, C, D, init_state, chunk)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"ssd_scan: bf16_launches takes bf16 x, got {x.dtype}")
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = -(-S // chunk)
    y = torch.empty_like(x)
    final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    states = torch.empty((Bb, nc, H, P, N), dtype=torch.float32, device=x.device)
    decay = torch.empty((Bb, nc, H), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_scan", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch(name, *args):
        # the closure holds the tensors, so the scratch outlives it
        def run():
            with torch.cuda.device(x.device):
                _build.check(getattr(lib, name)(*map(_ptr, args), stream), name)
        return name, run

    launches = [
        launch("ssd_bf16_states", x, dt, A_log, B, states, decay, Bb, S, H, G, P,
               N, chunk),
        launch("ssd_bf16_pass", states, decay, init_state, final, Bb, S, H, P, N,
               chunk),
        launch("ssd_bf16_output", x, dt, A_log, B, C, D, states, y, Bb, S, H, G,
               P, N, chunk),
    ]
    return (y, final), launches


def bwd_heads_per_tile(Bb: int, S: int, H: int, G: int, chunk: int, sms: int) -> int:
    """Heads per block (HT) of the bf16 backward's chunk kernel. Its grid is
    (chunk, b, group x ceil((H / G) / HT) tiles), one block per SM, and a
    block's time is about HT head steps plus one for the work it does once
    (C·Bᵀ, the summed products). Of HT in 1 .. min(BWD_MAX_HEADS_PER_TILE,
    H / G), the one with the fewest waves x (HT + 1) on ``sms`` SMs; ties
    go to the larger HT (fewer partials for the finish pass). The last
    tile of a group may be short."""
    R = H // G
    blocks = -(-S // chunk) * Bb * G
    best, best_cost = 1, None
    for ht in range(1, min(BWD_MAX_HEADS_PER_TILE, R) + 1):
        waves = -(-blocks * bwd_partials_per_group(H, G, ht) // sms)
        cost = waves * (ht + 1)
        if best_cost is None or cost <= best_cost:
            best, best_cost = ht, cost
    return best


def bwd_partials_per_group(H: int, G: int, heads_per_tile: int) -> int:
    """The dB / dC partials a group has in the bf16 chunk kernel's scratch
    (one per tile of heads; the last tile may be short)."""
    return -(-(H // G) // heads_per_tile)


def bwd_launches(x, dt, A_log, B, C, D, init_state, dy, dfinal=None, *,
                 chunk: int = 128, per_head: bool = False):
    """The backward as its kernel launches: → ((dx, ddt, dA_log, dB, dC,
    dD, d init_state or None), [(name, launch), ...]), run in order on the
    current stream by :func:`ssd_scan_bwd_cuda`. The forward's chunk
    states and pass are recomputed (S_in of every chunk); then the chunks'
    Σ exp(cum_i)·dy_i ⊗ C_i, the reverse pass over chunks, the chunk
    kernel, and the fixed-order sums over partials and chunks
    (``csrc/ssd_scan.cu``). bf16 runs on the tensor cores, its chunk kernel
    one block per (chunk, b, group x tile of :func:`bwd_heads_per_tile`
    heads) with a dB / dC partial per tile (``per_head``: the earlier
    kernel, a block and a partial per head); f32 on the CUDA cores in f64,
    a partial per head."""
    _validate(x, dt, A_log, B, C, D, init_state, chunk)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() \
            or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy must be contiguous {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    if x.dtype == torch.bfloat16 and dy.data_ptr() % 16:
        raise ValueError("ssd_scan_bwd: bf16 dy must start 16-byte aligned")
    if dfinal is not None and (dfinal.shape != (Bb, H, P, N)
                               or dfinal.dtype != torch.float32
                               or not dfinal.is_contiguous()
                               or dfinal.device != x.device):
        raise ValueError(f"ssd_scan_bwd: dfinal must be contiguous ({Bb}, {H}, "
                         f"{P}, {N}) float32")
    nc = -(-S // chunk)
    bf16 = x.dtype == torch.bfloat16
    if per_head and not bf16:
        raise ValueError("ssd_scan_bwd: the per-head chunk kernel takes bf16 x")
    f32 = dict(dtype=torch.float32, device=x.device)
    # the f32 instance keeps the chunk states in f64 (csrc/ssd_scan.cu: at
    # mamba2's decays ddt takes their f32 rounding to ~1e-3)
    st = dict(dtype=torch.float32 if bf16 else torch.float64, device=x.device)
    states = torch.empty((Bb, nc, H, P, N), **st)
    dstates = torch.empty((Bb, nc, H, P, N), **st)
    decay = torch.empty((Bb, nc, H), **st)
    parts = [torch.empty((Bb, nc, H), dtype=torch.float64, device=x.device)
             for _ in range(2)]                                          # dA, dD
    tiled = bf16 and not per_head
    ht = (bwd_heads_per_tile(Bb, S, H, G, chunk, torch.cuda.get_device_properties(
        x.device).multi_processor_count) if tiled else 1)
    per_group = bwd_partials_per_group(H, G, ht)
    heads = [torch.empty((Bb, S, G * per_group, N), **f32)
             for _ in range(2)]                                          # dB, dC
    dx = torch.empty_like(x)
    ddt = torch.empty((Bb, S, H), **f32)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA_log, dD = torch.empty((H,), **f32), torch.empty((H,), **f32)
    d_init = None if init_state is None else torch.empty((Bb, H, P, N), **f32)
    lib = _build.load("ssd_scan", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch(name, *args):
        def run():
            with torch.cuda.device(x.device):
                _build.check(getattr(lib, name)(*map(_ptr, args), stream), name)
        return name, run

    kind = "bf16" if bf16 else "f32"
    if bf16:
        final = torch.empty((Bb, H, P, N), **f32)
        walks = (launch("ssd_bf16_pass", states, decay, init_state, final, Bb, S, H, P,
                        N, chunk),
                 launch("ssd_bwd_pass", dstates, decay, dfinal, d_init, Bb, S, H, P, N,
                        chunk))
    else:
        walks = (launch("ssd_f64_walk", states, decay, init_state, None, Bb, S, H, P,
                        N, chunk, 0),
                 launch("ssd_f64_walk", dstates, decay, dfinal, d_init, Bb, S, H, P, N,
                        chunk, 1))
    chunk_args = (x, dt, A_log, B, C, D, dy, states, dstates, dx, ddt, heads[0], heads[1],
                  parts[0], parts[1], Bb, S, H, G, P, N, chunk)
    launches = [
        launch(f"ssd_{kind}_states", x, dt, A_log, B, states, decay, Bb, S, H, G, P,
               N, chunk),
        walks[0],
        launch(f"ssd_{kind}_dstates", dy, dt, A_log, C, dstates, Bb, S, H, G, P, N,
               chunk),
        walks[1],
        (launch("ssd_bwd_bf16", *chunk_args, ht) if tiled
         else launch(f"ssd_bwd_{kind}" + ("_per_head" if per_head else ""), *chunk_args)),
        launch(f"ssd_bwd_finish_{kind}", heads[0], heads[1], parts[0], parts[1],
               A_log, dB, dC, dA_log, dD, Bb, S, H, G, N, chunk, per_group),
    ]
    return (dx, ddt, dA_log, dB, dC, dD, d_init), launches


def ssd_scan_bwd_cuda(x, dt, A_log, B, C, D, init_state, dy, dfinal=None, *,
                      chunk: int = 128):
    """Launch the backward kernels (:func:`bwd_launches`); raises for
    inputs they do not take. → (dx, ddt, dA_log, dB, dC, dD, d init_state
    or None), as :func:`ssd_scan_bwd_plain`."""
    grads, launches = bwd_launches(x, dt, A_log, B, C, D, init_state, dy, dfinal,
                                   chunk=chunk)
    for _, run in launches:
        run()
    return grads


def _ssd_scan_bwd_per_head(x, dt, A_log, B, C, D, init_state, dy, dfinal=None, *,
                           chunk: int = 128):
    """The earlier bf16 backward (its chunk kernel one block and one dB / dC
    partial per head): on no path of the port, timed beside
    :func:`ssd_scan_bwd_cuda` by ``chip_smoke.py``."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"ssd_scan_bwd: bf16 x required, got {x.dtype}")
    grads, launches = bwd_launches(x, dt, A_log, B, C, D, init_state, dy, dfinal,
                                   chunk=chunk, per_head=True)
    for _, run in launches:
        run()
    return grads


def _cuda_cores(entry, x, dt, A_log, B, C, D, init_state, chunk: int):
    """One launch of the CUDA-core design, library entry ``entry``."""
    _validate(x, dt, A_log, B, C, D, init_state, chunk)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    fn = getattr(_build.load("ssd_scan", _SIGNATURES), entry)
    with torch.cuda.device(x.device):
        rc = fn(*map(_ptr, (x, dt, A_log, B, C, D, init_state, y, final)),
                Bb, S, H, G, P, N, chunk,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, entry)
    return y, final


def ssd_scan_cuda(x, dt, A_log, B, C, D, init_state: Optional[torch.Tensor] = None,
                  *, chunk: int = 128):
    """Launch the CUDA kernels; raises for inputs they do not take."""
    if x.dtype == torch.bfloat16:
        out, launches = bf16_launches(x, dt, A_log, B, C, D, init_state, chunk=chunk)
        for _, run in launches:
            run()
        return out
    return _cuda_cores("ssd_scan_f32", x, dt, A_log, B, C, D, init_state, chunk)


def _ssd_scan_cuda_cores(x, dt, A_log, B, C, D,
                         init_state: Optional[torch.Tensor] = None, *,
                         chunk: int = 128):
    """The earlier CUDA-core design on bf16 inputs: on no path of the port,
    timed beside the tensor-core passes by ``chip_smoke.py``."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"ssd_scan: bf16 x required, got {x.dtype}")
    return _cuda_cores("ssd_scan_bf16_cuda_cores", x, dt, A_log, B, C, D,
                       init_state, chunk)
