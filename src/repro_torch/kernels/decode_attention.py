"""Single-token decode attention: CUDA kernel and its plain version.

The port of ``repro.kernels.decode_attention``. One new query per sequence
attends over a KV cache: q (B, 1, H, Dh); k, v (B, S, Hkv, Dh) in f32 or
bf16, GQA by ``h // (H // Hkv)``; q_pos (B, 1), kv_pos (B, S) int32. A slot
is attended when ``kv_pos >= 0``, ``kv_pos <= q_pos`` (causal) and, with a
window, ``q_pos - kv_pos < window``; positions may be out of order (ring
caches). The softmax runs in f32 with scale Dh^-0.5 and the output has q's
dtype.

:func:`decode_attention_cuda` launches ``csrc/decode_attention.cu``: kv
split across blocks, fully masked tiles skipped, splits merged by
log-sum-exp. :func:`decode_attention_plain` is ``ref.attention_ref``.
``kernels.ops`` picks one by the tensor's device and counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

MAX_GROUP = 8          # query heads per kv head the kernel takes
MAX_HEAD_DIM = 128
ROWS_PER_BLOCK_STEP = 128   # 4 warps x 32 rows: split lengths are multiples
TARGET_BLOCKS = 264         # 2 blocks per SM of an H100 (132 SMs)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, _P)
_SIGNATURES = {"decode_attention_f32": _SIG, "decode_attention_bf16": _SIG}
_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}


def decode_attention_plain(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch (``ref.attention_ref``)."""
    return ref.attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                             window=window)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(B: int, S: int, Hkv: int):
    """(split_len, n_split) for S >= 1: cut S so that B·Hkv·n_split blocks
    fill the card, with splits a multiple of one block step long."""
    step = ROWS_PER_BLOCK_STEP
    n_split = max(1, min(_cdiv(S, step), _cdiv(TARGET_BLOCKS, B * Hkv)))
    split_len = _cdiv(_cdiv(S, n_split), step) * step
    return split_len, _cdiv(S, split_len)


def decode_attention_cuda(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel; raises for inputs it does not take."""
    B, one, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: CUDA tensors required, got {q.device}")
    if one != 1 or S < 1 or k.shape != (B, S, Hkv, Dh) or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: f32 or bf16 q/k/v of one dtype, "
                         f"got {q.dtype} {k.dtype} {v.dtype}")
    vec = 16 // q.element_size()
    if (H % Hkv or H // Hkv > MAX_GROUP or Dh > MAX_HEAD_DIM or Dh % vec
            or k.data_ptr() % 16):
        raise ValueError(f"decode_attention: unsupported H={H} Hkv={Hkv} "
                         f"Dh={Dh} (group <= {MAX_GROUP}, Dh <= "
                         f"{MAX_HEAD_DIM} and a multiple of {vec})")
    for t in (q, k, v):
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError("decode_attention: contiguous q/k/v on one device")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")
    qp = q_pos.reshape(B).to(torch.int32).contiguous()
    kp = kv_pos.to(torch.int32).contiguous()
    if kp.shape != (B, S) or qp.device != q.device or kp.device != q.device:
        raise ValueError("decode_attention: q_pos (B, 1) and kv_pos (B, S) "
                         "on q's device")
    split_len, n_split = split_plan(B, S, Hkv)
    out = torch.empty_like(q)
    part_ml = torch.empty(B * H * n_split * 2, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(B * H * n_split * Dh, dtype=torch.float32,
                           device=q.device)
    fn = getattr(_build.load("decode_attention", _SIGNATURES), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                kp.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
                part_acc.data_ptr(), B, S, H, Hkv, Dh, int(causal),
                0 if window is None else int(window), split_len, n_split,
                Dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, _ENTRY[q.dtype])
    return out
