"""Full-sequence (prefill) attention: CUDA kernel and its plain version.

The port of ``repro.kernels.flash_attention``. q (B, Sq, H, Dh) attends over
k, v (B, Skv, Hkv, Dh) in f32 or bf16, GQA by ``h // (H // Hkv)``; q_pos
(B, Sq), kv_pos (B, Skv) int32. A pair is attended when ``kv_pos >= 0``,
``kv_pos <= q_pos`` (causal) and, with a window, ``q_pos - kv_pos <
window``; positions may be out of order. The softmax runs online over kv
chunks in f32 with scale Dh^-0.5, a row with ``q_pos < 0`` gives exactly 0,
and the output has q's dtype.

:func:`flash_attention_cuda` launches ``csrc/flash_attention.cu``: in bf16
one block per q tile of 128 rows, head and batch row on the tensor cores
(wgmma, with K/V tiles brought by TMA through a ring of stages and masked
tiles never loaded); in f32 one block per q tile of 64 rows on the CUDA
cores. Its ragged ends are masked in the kernel, so no shape is padded.
:func:`flash_attention_plain` is the forward of ``flash_jnp.flash_attention_jnp``, chunked over q rows as
well so that a long prefill never holds the (Sq, Skv) score matrix.
``kernels.ops`` picks one by the tensor's device and counts the launches.
Dh is 64, 80 or 128 on the card (the reference tiles the same three).

The backward (the port of ``flash_jnp._flash_bwd``, which
``kernels.ops.FlashAttention`` runs): with ``return_lse`` the forward also
returns each row's log-sum-exp (B, Sq, H) f32, from which the backward
recomputes the softmax block by block. :func:`flash_attention_bwd_cuda`
launches ``csrc/flash_attention_bwd.cu`` (in bf16 on wgmma, its tiles brought
by TMA); :func:`flash_attention_bwd_plain` is its plain version. A row whose output the forward forces to 0
(``q_pos < 0``) or that has no valid key is dead: its log-sum-exp is
NEG_INF and it has no gradient. The reference's backward differs on one
case the models never reach: a row with ``q_pos < 0`` that has valid keys
(non-causal) passes it gradients although its output is the constant 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF

HEAD_DIMS = (64, 80, 128)    # the head dims the kernels are built for
CHUNK = 128                  # q and kv rows per step of the plain version

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = (_P,) * 7 + (_I,) * 8 + (ctypes.c_float, _P)
_SIGNATURES = {"flash_attention_f32": _SIG, "flash_attention_bf16": _SIG,
               "flash_attention_bf16_cuda_cores": _SIG}
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_SIG = (_P,) * 12 + (_I,) * 8 + (ctypes.c_float, _P)
_BWD_SIGNATURES = {"flash_attention_bwd_f32": _BWD_SIG,
                   "flash_attention_bwd_bf16": _BWD_SIG,
                   "flash_attention_bwd_bf16_mma_sync": _BWD_SIG}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}


def valid_pairs(Sq: int, Skv: int, *, causal: bool = True,
                window: Optional[int] = None) -> int:
    """(q, kv) pairs one row and head attends when its Sq queries sit at the
    last Sq of Skv positions 0 … Skv-1 (prefill and training): query p sees
    min(p + 1, W) keys causally, Skv - max(0, p - W + 1) otherwise."""
    W = window if window is not None else Skv + 1
    a, b = Skv - Sq, Skv
    m = min(max(a, W - 1), b)           # queries a … m-1 see no window edge
    n = b - m
    if causal:
        return (m - a) * (a + m + 1) // 2 + n * W
    return Sq * Skv - (n * (m + b - 1) // 2 - n * (W - 1))


def cost(q, k, *, causal: bool = True, window: Optional[int] = None,
         pairs: Optional[int] = None, lse: bool = False) -> dict:
    """The forward kernel's work on q (B, Sq, H, Dh) over k (B, Skv, Hkv,
    Dh): 4·Dh·H FLOPs a valid pair (``pairs``, summed over rows; default
    :func:`valid_pairs` of every row) in q's dtype; q, k, v and both
    position vectors read once, the output (and with ``lse`` the
    log-sum-exp) written once."""
    B, Sq, H, Dh = q.shape
    Skv = k.shape[1]
    if pairs is None:
        pairs = B * valid_pairs(Sq, Skv, causal=causal, window=window)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + 4 * (B * Sq + B * Skv) + (4 * B * Sq * H if lse else 0)
    return {"flops": 4 * Dh * H * pairs, "bytes": nbytes, "dtype": q.dtype}


def cost_bwd(q, k, *, causal: bool = True, window: Optional[int] = None,
             pairs: Optional[int] = None) -> dict:
    """The backward kernels' work: 10·Dh·H FLOPs a valid pair (the
    recomputed scores, dP, dS and the dQ, dK, dV products); q, k, v, the
    output, dO and the log-sum-exp read once, dQ, dK, dV written once,
    with both position vectors."""
    B, Sq, H, Dh = q.shape
    Skv = k.shape[1]
    if pairs is None:
        pairs = B * valid_pairs(Sq, Skv, causal=causal, window=window)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 4 * B * Sq * H + 4 * (B * Sq + B * Skv)
    return {"flops": 10 * Dh * H * pairs, "bytes": nbytes, "dtype": q.dtype}


def _valid(qp, kp, causal: bool, window: Optional[int]) -> torch.Tensor:
    """qp (B, q), kp (B, k) → (B, 1, 1, q, k) bool."""
    qp = qp[:, None, None, :, None]
    kp = kp[:, None, None, None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & ((qp - kp) < window)
    return ok


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                          window: Optional[int] = None, return_lse: bool = False):
    """The same function in plain PyTorch: online softmax over kv chunks of
    ``CHUNK`` rows for each q chunk of ``CHUNK`` rows, in f32. With
    ``return_lse`` → (out, lse (B, Sq, H) f32), as ``_fwd_core`` returns
    them, NEG_INF on dead rows."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = Dh ** -0.5
    qc = kc = CHUNK
    qp_all, kp_all = q_pos.to(torch.int32), kv_pos.to(torch.int32)
    kf, vf = k.float(), v.float()
    neg = torch.tensor(NEG_INF, device=q.device)
    zero = torch.zeros((), device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), device=q.device) if return_lse else None
    for q0 in range(0, Sq, qc):
        qb = q[:, q0:q0 + qc].float()
        n = qb.shape[1]
        qb = qb.reshape(B, n, Hkv, g, Dh)
        qp = qp_all[:, q0:q0 + n]
        m = torch.full((B, Hkv, g, n), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, g, n), device=q.device)
        acc = torch.zeros((B, Hkv, g, n, Dh), device=q.device)
        for k0 in range(0, Skv, kc):
            ok = _valid(qp, kp_all[:, k0:k0 + kc], causal, window)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf[:, k0:k0 + kc]) * scale
            s = torch.where(ok, s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new[..., None]), zero)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, k0:k0 + kc])
            m = m_new
        ob = acc / torch.clamp(l, min=1e-30)[..., None]
        ob = torch.where((qp < 0)[:, None, None, :, None], zero, ob)
        out[:, q0:q0 + n] = ob.permute(0, 3, 1, 2, 4).reshape(B, n, H, Dh) \
            .to(q.dtype)
        if return_lse:
            dead = (l <= 0) | (qp < 0)[:, None, None, :]
            ls = torch.where(dead, neg, m + torch.log(torch.clamp(l, min=1e-30)))
            lse[:, q0:q0 + n] = ls.permute(0, 3, 1, 2).reshape(B, n, H)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, q_pos, kv_pos, *,
                              causal: bool = True, window: Optional[int] = None):
    """The backward in plain PyTorch, the port of ``flash_jnp._flash_bwd``
    on ragged shapes: for each q chunk and kv chunk of ``CHUNK`` rows, P is
    recomputed from the saved log-sum-exp (masked before the exp), and dq,
    dk, dv accumulate in f32; dk and dv are summed over each GQA group.
    → (dq, dk, dv) in q's, k's and v's dtypes."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = Dh ** -0.5
    qp_all, kp_all = q_pos.to(torch.int32), kv_pos.to(torch.int32)
    kf, vf = k.float(), v.float()
    zero = torch.zeros((), device=q.device)
    delta = (out.float() * dout.float()).sum(-1)                  # (B, Sq, H)
    live = (lse > NEG_INF / 2) & (qp_all >= 0)[:, :, None]

    def heads_last(t, q0, n):        # (B, Sq, H) → (B, Hkv, g, n, 1)
        return t[:, q0:q0 + n].reshape(B, n, Hkv, g).permute(0, 2, 3, 1)[..., None]

    dq = torch.zeros((B, Sq, Hkv, g, Dh), device=q.device)
    dk = torch.zeros((B, Skv, Hkv, Dh), device=q.device)
    dv = torch.zeros((B, Skv, Hkv, Dh), device=q.device)
    for q0 in range(0, Sq, CHUNK):
        qb = q[:, q0:q0 + CHUNK].float()
        n = qb.shape[1]
        qb = qb.reshape(B, n, Hkv, g, Dh)
        dob = dout[:, q0:q0 + CHUNK].float().reshape(B, n, Hkv, g, Dh)
        qp = qp_all[:, q0:q0 + n]
        lse_t, dl_t = heads_last(lse, q0, n), heads_last(delta, q0, n)
        lv_t = heads_last(live, q0, n)
        for k0 in range(0, Skv, CHUNK):
            kb, vb = kf[:, k0:k0 + CHUNK], vf[:, k0:k0 + CHUNK]
            ok = _valid(qp, kp_all[:, k0:k0 + CHUNK], causal, window) & lv_t
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            p = torch.exp(torch.where(ok, s - lse_t, -torch.inf))
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
            ds = torch.where(ok, p * (dp - dl_t), zero) * scale
            dv[:, k0:k0 + CHUNK] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
            dk[:, k0:k0 + CHUNK] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
            dq[:, q0:q0 + n] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
    return (dq.reshape(B, Sq, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v, q_pos, kv_pos, window: Optional[int]):
    """Raise for inputs the kernels do not take. → (q_pos, kv_pos) as
    contiguous int32."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: CUDA tensors required, got {q.device}")
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Sq < 1 or Skv < 1 or k.shape != (B, Skv, Hkv, Dh) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: f32 or bf16 q/k/v of one dtype, "
                         f"got {q.dtype} {k.dtype} {v.dtype}")
    if Hkv < 1 or H % Hkv or Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported H={H} Hkv={Hkv} Dh={Dh} "
                         f"(H a multiple of Hkv, Dh in {HEAD_DIMS})")
    for t in (q, k, v):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError("flash_attention: contiguous q/k/v on one device")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("flash_attention: bf16 q/k/v must start 16-byte "
                             "aligned (TMA reads them)")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    qp = q_pos.to(torch.int32).contiguous()
    kp = kv_pos.to(torch.int32).contiguous()
    if (qp.shape != (B, Sq) or kp.shape != (B, Skv) or qp.device != q.device
            or kp.device != q.device):
        raise ValueError("flash_attention: q_pos (B, Sq) and kv_pos (B, Skv) "
                         "on q's device")
    return qp, kp


def _launch(entry, q, k, v, q_pos, kv_pos, causal: bool,
            window: Optional[int], return_lse: bool = False):
    """Check the inputs and run the library's ``entry`` → out, or (out,
    lse) with ``return_lse``."""
    qp, kp = _check(q, k, v, q_pos, kv_pos, window)
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), device=q.device) if return_lse else None
    fn = getattr(_build.load("flash_attention", _SIGNATURES), entry)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                kp.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Skv, H, Hkv, Dh,
                int(causal), 0 if window is None else int(window), Dh ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, entry)
    return (out, lse) if return_lse else out


def flash_attention_cuda(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                         window: Optional[int] = None, return_lse: bool = False):
    """Launch the CUDA kernel; raises for inputs it does not take. With
    ``return_lse`` → (out, lse (B, Sq, H) f32); without, no lse is
    written."""
    return _launch(_ENTRY.get(q.dtype), q, k, v, q_pos, kv_pos, causal, window,
                   return_lse)


def _launch_bwd(entry, q, k, v, out, lse, dout, q_pos, kv_pos, causal: bool,
                window: Optional[int]):
    """Check the backward's inputs and run the library's ``entry`` → (dq,
    dk, dv)."""
    qp, kp = _check(q, k, v, q_pos, kv_pos, window)
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    for t in (out, dout):
        if (t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError("flash_attention_bwd: out and dout contiguous, "
                             "of q's shape, dtype and device")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("flash_attention_bwd: bf16 out and dout must start "
                             "16-byte aligned (TMA reads dout)")
    if (lse.shape != (B, Sq, H) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse (B, Sq, H) f32 on q's device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Sq, H), device=q.device)
    fn = getattr(_build.load("flash_attention_bwd", _BWD_SIGNATURES), entry)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), qp.data_ptr(), kp.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                B, Sq, Skv, H, Hkv, Dh, int(causal),
                0 if window is None else int(window), Dh ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, entry)
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, q_pos, kv_pos, *,
                             causal: bool = True, window: Optional[int] = None):
    """Launch the backward kernels (Δ, dK/dV, dQ; one call) on the
    forward's inputs, its output and log-sum-exp and the output gradient:
    in bf16 on the tensor cores (``wgmma``, tiles brought by TMA), in f32
    on the CUDA cores. → (dq, dk, dv) in the inputs' dtype; raises for
    inputs it does not take."""
    return _launch_bwd(_BWD_ENTRY.get(q.dtype), q, k, v, out, lse, dout, q_pos, kv_pos,
                       causal, window)


def _flash_attention_bwd_mma_sync(q, k, v, out, lse, dout, q_pos, kv_pos, *,
                                  causal: bool = True, window: Optional[int] = None):
    """The earlier bf16 backward on ``mma.sync``: on no path of the port,
    timed beside the wgmma kernels by ``chip_smoke.py``."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd: bf16 q/k/v required, got {q.dtype}")
    return _launch_bwd("flash_attention_bwd_bf16_mma_sync", q, k, v, out, lse, dout,
                       q_pos, kv_pos, causal, window)


def _flash_attention_cuda_cores(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                                window: Optional[int] = None) -> torch.Tensor:
    """The earlier CUDA-core design on bf16 inputs: on no path of the port,
    timed beside the tensor-core kernel by ``chip_smoke.py``."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: bf16 q/k/v required, got {q.dtype}")
    return _launch("flash_attention_bf16_cuda_cores", q, k, v, q_pos, kv_pos,
                   causal, window)
