"""Public kernel entry points: dispatch by tensor device, launch counts.

Every entry point runs the plain PyTorch version for a tensor on the CPU
and launches the hand-written CUDA kernel for a tensor on a CUDA device;
there is no fallback between the two. On the meta device (a shape-only
trace) it hands the kernel's ``cost`` to :data:`cost_hook` and returns
empty results of the right shapes and dtypes; any other device raises.
Each
CUDA launch adds one to its kernel's count in :data:`LAUNCHES`, so a run
can show that its main path went through the kernels (``chip_smoke.py``
zeroes the counts, drives the server and reads them). No gradient is
dropped: ``attention`` and ``ssd`` differentiate through their kernels,
and the kernel without a backward (decode attention) refuses CUDA inputs
that require grad (:func:`refuse_grad`).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mpk_guard as _mg
from repro_torch.kernels import ssd_scan as _ss

KERNELS = ("guard_copy", "mac_batch", "mac_init_state", "mac_update",
           "mac_finalize", "decode_attention", "flash_attention",
           "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd",
           "mac_batch_two_pass", "mac_update_two_pass")


class LaunchCounts:
    """Per-kernel CUDA launch counters, safe to bump from many threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n: Dict[str, int] = dict.fromkeys(KERNELS, 0)

    def bump(self, name: str) -> None:
        with self._lock:
            self._n[name] += 1

    def reset(self) -> None:
        with self._lock:
            self._n = dict.fromkeys(KERNELS, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)


LAUNCHES = LaunchCounts()

# Called as ``cost_hook(name, cost)`` for each kernel call on the meta
# device, ``cost`` the kernel module's ``cost(...)`` dict ({"flops",
# "bytes", "dtype"}); ``roofline.count`` sets it while it counts, and with
# None a meta call records nothing.
cost_hook: Optional[Callable[[str, dict], None]] = None


def needs_grad(*tensors) -> bool:
    """True when autograd would differentiate through these inputs."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd would need a backward that the CUDA kernel
    ``what`` does not have: its output carries no ``grad_fn``, so running on
    would drop every gradient through it without a word."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input requires "
            f"grad; run under torch.no_grad(), or use the plain version "
            f"(Impl(...='plain')) to differentiate")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type in ("cpu", "meta"):
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for tensors on {t.device}")


def _on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def _meta(name: str, cost: dict, *outs):
    """A kernel's call on the meta device: its cost handed to
    :data:`cost_hook`, ``outs`` (empty meta tensors) returned as the kernel
    would return them."""
    if cost_hook is not None:
        cost_hook(name, cost)
    return outs[0] if len(outs) == 1 else outs


def _u32(t, *shape):
    return torch.empty(shape, dtype=torch.uint32, device=t.device)


def guard_copy(payload_u32: torch.Tensor, tag: int, expected_mac: int):
    """(copy, mac (1,) uint32, ok (1,) int32) of an (n, 128) uint32
    payload; n may be 0 (a header-only frame)."""
    if _on_meta(payload_u32):
        return _meta("guard_copy", _mg.cost("guard_copy", payload_u32),
                     torch.empty_like(payload_u32), _u32(payload_u32, 1),
                     torch.empty(1, dtype=torch.int32, device="meta"))
    if not _on_cuda(payload_u32):
        return _mg.guard_copy_plain(payload_u32, tag, expected_mac)
    out = _mg.guard_copy_cuda(payload_u32, tag, expected_mac)
    LAUNCHES.bump("guard_copy")
    return out


def mac_batch(stack_u32: torch.Tensor, tag: int) -> torch.Tensor:
    """(N, rows, 128) uint32 stack → (N,) uint32 MACs."""
    if _on_meta(stack_u32):
        return _meta("mac_batch", _mg.cost("mac_batch", stack_u32),
                     _u32(stack_u32, stack_u32.shape[0]))
    if not _on_cuda(stack_u32):
        return _mg.mac_batch_plain(stack_u32, tag)
    out = _mg.mac_batch_cuda(stack_u32, tag)
    LAUNCHES.bump("mac_batch")
    return out


def mac_batch_two_pass(stack_u32: torch.Tensor, tag: int) -> torch.Tensor:
    """:func:`mac_batch` by the earlier two-launch kernel, the MAC of the
    legacy copy plane (``framing.ZERO_COPY = False``); the same words."""
    if _on_meta(stack_u32):
        return _meta("mac_batch_two_pass", _mg.cost("mac_batch", stack_u32),
                     _u32(stack_u32, stack_u32.shape[0]))
    if not _on_cuda(stack_u32):
        return _mg.mac_batch_plain(stack_u32, tag)
    out = _mg._mac_batch_two_pass(stack_u32, tag)
    LAUNCHES.bump("mac_batch_two_pass")
    return out


def mac_init_state(tag: int, device) -> torch.Tensor:
    """Fresh (128,) uint32 streaming-MAC state for ``tag`` on ``device``."""
    device = torch.device(device)
    if device.type == "cpu":
        return _mg.mac_init_state_plain(tag, device)
    if device.type == "meta":
        h = torch.empty(128, dtype=torch.uint32, device=device)
        return _meta("mac_init_state", _mg.cost("mac_init_state", h), h)
    if device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {device}")
    out = _mg.mac_init_state_cuda(tag, device)
    LAUNCHES.bump("mac_init_state")
    return out


def mac_update(h: torch.Tensor, block_u32: torch.Tensor) -> torch.Tensor:
    """Advance a streaming-MAC state over one (m, 128) uint32 block."""
    if _on_meta(block_u32):
        return _meta("mac_update", _mg.cost("mac_update", block_u32),
                     torch.empty_like(h))
    if not _on_cuda(block_u32):
        return _mg.mac_update_plain(h, block_u32)
    out = _mg.mac_update_cuda(h, block_u32)
    LAUNCHES.bump("mac_update")
    return out


def mac_update_two_pass(h: torch.Tensor, block_u32: torch.Tensor) -> torch.Tensor:
    """:func:`mac_update` by the earlier two-launch kernel, the MAC of the
    legacy copy plane (``framing.ZERO_COPY = False``); the same state."""
    if _on_meta(block_u32):
        return _meta("mac_update_two_pass", _mg.cost("mac_update", block_u32),
                     torch.empty_like(h))
    if not _on_cuda(block_u32):
        return _mg.mac_update_plain(h, block_u32)
    out = _mg._mac_update_two_pass(h, block_u32)
    LAUNCHES.bump("mac_update_two_pass")
    return out


def mac_finalize(h: torch.Tensor) -> torch.Tensor:
    """Fold a streaming-MAC state to the (1,) uint32 MAC word."""
    if _on_meta(h):
        return _meta("mac_finalize", _mg.cost("mac_finalize", h), _u32(h, 1))
    if not _on_cuda(h):
        return _mg.mac_finalize_plain(h)
    out = _mg.mac_finalize_cuda(h)
    LAUNCHES.bump("mac_finalize")
    return out


def decode_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention, q (B, 1, H, Dh) over k/v (B, S, Hkv, Dh).
    The kernel has no backward: on a CUDA tensor that requires grad it
    raises."""
    if _on_meta(q):
        return _meta("decode_attention", _da.cost(q, k, kv_pos), torch.empty_like(q))
    if not _on_cuda(q):
        return _da.decode_attention_plain(q, k, v, q_pos, kv_pos,
                                          causal=causal, window=window)
    refuse_grad("decode_attention", q, k, v)
    out = _da.decode_attention_cuda(q, k, v, q_pos, kv_pos, causal=causal,
                                    window=window)
    LAUNCHES.bump("decode_attention")
    return out


def attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention, q (B, Sq, H, Dh) over k/v (B, Skv, Hkv, Dh),
    any Sq and Skv (the kernel masks its ragged tiles; nothing is padded).
    Under grad mode with an input that requires grad it runs as
    :class:`FlashAttention`, whose backward is a kernel too."""
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window)
    if _on_meta(q):
        return _meta("flash_attention", _fa.cost(q, k, causal=causal, window=window),
                     torch.empty_like(q))
    if not _on_cuda(q):
        return _fa.flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                                         window=window)
    out = _fa.flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window)
    LAUNCHES.bump("flash_attention")
    return out


def attention_lse(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                  window: Optional[int] = None):
    """Forward-only :func:`attention` that also returns each row's
    log-sum-exp → (out in q's dtype, lse (B, Sq, H) f32, NEG_INF on dead
    rows): the partial that ``core.ring_attention`` merges. On a CUDA
    tensor that requires grad it raises."""
    if _on_meta(q):
        return _meta("flash_attention", _fa.cost(q, k, causal=causal, window=window,
                                                 lse=True), *_flash_meta_out(q))
    if not _on_cuda(q):
        return _fa.flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                                         window=window, return_lse=True)
    refuse_grad("attention_lse", q, k, v)
    out = _fa.flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window, return_lse=True)
    LAUNCHES.bump("flash_attention")
    return out


def _flash_meta_out(q):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), torch.empty((B, Sq, H), dtype=torch.float32,
                                            device=q.device)


def _ssd_meta_out(x, B):
    Bb, _, H, P = x.shape
    return torch.empty_like(x), torch.empty((Bb, H, P, B.shape[-1]),
                                            dtype=torch.float32, device=x.device)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention, the port of ``flash_jnp._flash`` (its
    ``custom_vjp``): ``FlashAttention.apply(q, k, v, q_pos, kv_pos, causal,
    window)`` → out. On CUDA tensors the forward launches the flash kernel
    with the log-sum-exp and the backward launches the backward kernel;
    on the CPU both run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window):
        if _on_meta(q):
            out, lse = _meta("flash_attention",
                             _fa.cost(q, k, causal=causal, window=window, lse=True),
                             *_flash_meta_out(q))
        elif _on_cuda(q):
            out, lse = _fa.flash_attention_cuda(q, k, v, q_pos, kv_pos,
                                                causal=causal, window=window,
                                                return_lse=True)
            LAUNCHES.bump("flash_attention")
        else:
            out, lse = _fa.flash_attention_plain(q, k, v, q_pos, kv_pos,
                                                 causal=causal, window=window,
                                                 return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:             # the bf16 kernel reads 16-byte pieces
            dout = dout.clone()
        args = (q, k, v, out, lse, dout, q_pos, kv_pos)
        if _on_meta(q):
            dq, dk, dv = _meta("flash_attention_bwd",
                               _fa.cost_bwd(q, k, causal=ctx.causal, window=ctx.window),
                               torch.empty_like(q), torch.empty_like(k),
                               torch.empty_like(v))
        elif _on_cuda(q):
            dq, dk, dv = _fa.flash_attention_bwd_cuda(*args, causal=ctx.causal,
                                                      window=ctx.window)
            LAUNCHES.bump("flash_attention_bwd")
        else:
            dq, dk, dv = _fa.flash_attention_bwd_plain(*args, causal=ctx.causal,
                                                       window=ctx.window)
        return dq, dk, dv, None, None, None, None


def ssd(x, dt, A_log, B, C, D, init_state=None, *, chunk: int = 128):
    """The Mamba2 SSD scan over a whole sequence → (y, final state f32).
    A sequence that is not a chunk multiple ends in identity steps (dt = 0):
    the plain version pads them, the kernel masks them. Under grad mode
    with an input that requires grad it runs as :class:`SSDScan`, whose
    backward is a kernel too."""
    if needs_grad(x, dt, A_log, B, C, D, init_state):
        return SSDScan.apply(x, dt, A_log, B, C, D, init_state, chunk)
    if _on_meta(x):
        return _meta("ssd_scan", _ss.cost(x, dt, B, init_state, chunk=chunk),
                     *_ssd_meta_out(x, B))
    if not _on_cuda(x):
        return _ss.ssd_scan_plain(x, dt, A_log, B, C, D, init_state, chunk=chunk)
    out = _ss.ssd_scan_cuda(x, dt, A_log, B, C, D, init_state, chunk=chunk)
    LAUNCHES.bump("ssd_scan")
    return out


class SSDScan(torch.autograd.Function):
    """The differentiable scan, the port of JAX's autodiff through
    ``ssd_jnp.ssd_chunked``: ``SSDScan.apply(x, dt, A_log, B, C, D,
    init_state, chunk)`` → (y, final state). On CUDA tensors the forward
    launches the scan's kernels and the backward the backward's; on the CPU
    both run their plain versions. The final state's gradient may be
    absent (training drops the state)."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B, C, D, init_state, chunk):
        ctx.set_materialize_grads(False)
        if _on_meta(x):
            y, final = _meta("ssd_scan", _ss.cost(x, dt, B, init_state, chunk=chunk),
                             *_ssd_meta_out(x, B))
        elif _on_cuda(x):
            y, final = _ss.ssd_scan_cuda(x, dt, A_log, B, C, D, init_state,
                                         chunk=chunk)
            LAUNCHES.bump("ssd_scan")
        else:
            y, final = _ss.ssd_scan_plain(x, dt, A_log, B, C, D, init_state,
                                          chunk=chunk)
        ctx.save_for_backward(x, dt, A_log, B, C, D, init_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A_log, B, C, D, init_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dy.data_ptr() % 16:               # the bf16 kernels read 16-byte pieces
            dy = dy.clone()
        if dfinal is not None:
            dfinal = dfinal.float().contiguous()
        args = (x, dt, A_log, B, C, D, init_state, dy, dfinal)
        if _on_meta(x):
            grads = _meta("ssd_scan_bwd", _ss.cost_bwd(x, dt, B, chunk=ctx.chunk),
                          *(None if t is None else torch.empty_like(t)
                            for t in (x, dt, A_log, B, C, D, init_state)))
        elif _on_cuda(x):
            grads = _ss.ssd_scan_bwd_cuda(*args, chunk=ctx.chunk)
            LAUNCHES.bump("ssd_scan_bwd")
        else:
            grads = _ss.ssd_scan_bwd_plain(*args, chunk=ctx.chunk)
        return (*grads, None)
