"""Single-token decode attention: CUDA kernel and its plain version.

The port of ``repro.kernels.decode_attention``. One new query per sequence
attends over a KV cache: q (B, 1, H, Dh); k, v (B, S, Hkv, Dh) in f32 or
bf16, GQA by ``h // (H // Hkv)``; q_pos (B, 1), kv_pos (B, S) int32. A slot
is attended when ``kv_pos >= 0``, ``kv_pos <= q_pos`` (causal) and, with a
window, ``q_pos - kv_pos < window``; positions may be out of order (ring
caches). The softmax runs in f32 with scale Dh^-0.5 and the output has q's
dtype.

:func:`decode_attention_cuda` launches ``decode_fused`` of
``csrc/decode_attention.cu`` once per call: kv split across blocks by
:func:`split_plan`, K/V tiles of ``TILE_ROWS`` streamed through shared
memory, fully masked tiles never loaded, and the splits merged by
log-sum-exp by the last block of each (b, kv head) to finish; its partials
and arrival counters live in ``workspace``. :func:`decode_attention_plain`
is ``ref.attention_ref``. ``kernels.ops`` picks one by the tensor's device
and counts the launches. :func:`_decode_attention_split_merge` is the
earlier two-launch design, kept only as a yardstick for ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels import workspace

MAX_GROUP = 8          # query heads per kv head the kernel takes
MAX_HEAD_DIM = 128
TILE_ROWS = 64         # kv rows per tile: split lengths are multiples
MAX_TILES = 256        # tiles per split
MAX_SPLITS = 512
MIN_SPLIT_TILES = 16   # tiles a split at least: a split costs a merge, ~2 µs
                       # on the H100, more than a block's walk of a few tiles
TARGET_BLOCKS = 396    # slots when the occupancy is not known: 3 blocks x 132 SMs

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, _P)
_SIG_EARLIER = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                _I, ctypes.c_float, _P)
_SIGNATURES = {"decode_attention_f32": _SIG, "decode_attention_bf16": _SIG,
               "decode_attention_blocks_per_sm": (_I, _I, _I, ctypes.POINTER(_I)),
               "decode_attention_split_merge_f32": _SIG_EARLIER,
               "decode_attention_split_merge_bf16": _SIG_EARLIER}
_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}

_SLOTS_LOCK = threading.Lock()
_SLOTS: Dict[Tuple[int, torch.dtype, int, int], int] = {}


def decode_attention_plain(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch (``ref.attention_ref``)."""
    return ref.attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                             window=window)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(B: int, S: int, Hkv: int, slots: int = TARGET_BLOCKS):
    """(split_len, n_split) for S >= 1: split each (b, kv head)'s S rows so
    that the B·Hkv·n_split blocks fill the ``slots`` that fit on the card at
    once (one wave), in whole tiles of ``TILE_ROWS`` and at least
    ``MIN_SPLIT_TILES`` tiles a split; one split when B·Hkv alone fills the
    card, more when a split would pass ``MAX_TILES``."""
    tiles = _cdiv(S, TILE_ROWS)
    n_split = max(1, min(slots // (B * Hkv), _cdiv(tiles, MIN_SPLIT_TILES)),
                  _cdiv(tiles, MAX_TILES))
    split_tiles = _cdiv(tiles, min(n_split, MAX_SPLITS))
    return split_tiles * TILE_ROWS, _cdiv(tiles, split_tiles)


def _slots(dev: int, dtype: torch.dtype, Dh: int, g: int) -> int:
    """Blocks of the kernel instance for (dtype, Dh, g) that fit on CUDA
    device ``dev`` at once: its occupancy per SM times the SM count
    (cached)."""
    key = (dev, dtype, Dh, g)
    with _SLOTS_LOCK:
        n = _SLOTS.get(key)
        if n is None:
            per_sm = _I(0)
            lib = _build.load("decode_attention", _SIGNATURES)
            _build.check(lib.decode_attention_blocks_per_sm(
                int(dtype == torch.bfloat16), Dh, g, ctypes.byref(per_sm)),
                "decode_attention occupancy")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            n = _SLOTS[key] = max(1, per_sm.value) * sms
        return n


def _checked(q, k, v, q_pos, kv_pos, window):
    """Validate the inputs → (qp (B,) int32, kp (B, S) int32), converted only
    when they are not int32 and contiguous already."""
    B, one, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if not q.is_cuda:
        raise ValueError(f"decode_attention: CUDA tensors required, got {q.device}")
    if one != 1 or S < 1 or k.shape != (B, S, Hkv, Dh) or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: f32 or bf16 q/k/v of one dtype, "
                         f"got {q.dtype} {k.dtype} {v.dtype}")
    vec = 16 // q.element_size()
    if H % Hkv or H // Hkv > MAX_GROUP or Dh > MAX_HEAD_DIM or Dh % vec:
        raise ValueError(f"decode_attention: unsupported H={H} Hkv={Hkv} "
                         f"Dh={Dh} (group <= {MAX_GROUP}, Dh <= "
                         f"{MAX_HEAD_DIM} and a multiple of {vec})")
    dev = q.get_device()
    for t in (q, k, v):
        if not t.is_contiguous() or t.get_device() != dev or t.data_ptr() % 16:
            raise ValueError("decode_attention: contiguous, 16-byte aligned "
                             "q/k/v on one device")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")
    qp = q_pos
    if qp.dtype != torch.int32 or not qp.is_contiguous():
        qp = qp.to(torch.int32).contiguous()
    kp = kv_pos
    if kp.dtype != torch.int32 or not kp.is_contiguous():
        kp = kp.to(torch.int32).contiguous()
    if (qp.numel() != B or kp.shape != (B, S) or qp.get_device() != dev
            or kp.get_device() != dev):
        raise ValueError("decode_attention: q_pos (B, 1) and kv_pos (B, S) "
                         "on q's device")
    return qp, kp


def decode_attention_cuda(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel once; raises for inputs it does not take."""
    qp, kp = _checked(q, k, v, q_pos, kv_pos, window)
    B, _, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dev = q.get_device()
    split_len, n_split = split_plan(B, S, Hkv, _slots(dev, q.dtype, Dh, H // Hkv))
    if split_len > MAX_TILES * TILE_ROWS:
        raise ValueError(f"decode_attention: S={S} is longer than the kernel takes")
    stream = workspace.current_stream(dev)
    n_part = B * H * n_split if n_split > 1 else 0     # acc (Dh floats), then m, l
    counters, scratch = workspace.scratch("decode_attention", dev, stream,
                                          counters=B * Hkv, nbytes=n_part * (Dh + 2) * 4)
    out = torch.empty_like(q)
    fn = getattr(_build.load("decode_attention", _SIGNATURES), _ENTRY[q.dtype])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
            out.data_ptr(), scratch + n_part * Dh * 4, scratch, counters, B, S, H,
            Hkv, Dh, int(causal), 0 if window is None else int(window), split_len,
            n_split, Dh ** -0.5, stream)
    if dev == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    _build.check(rc, _ENTRY[q.dtype])
    return out


def _split_merge_plan(B: int, S: int, Hkv: int):
    """The earlier design's plan: at most 264 blocks, splits a multiple of
    its 128-row block step."""
    step = 128
    n_split = max(1, min(_cdiv(S, step), _cdiv(264, B * Hkv)))
    split_len = _cdiv(_cdiv(S, n_split), step) * step
    return split_len, _cdiv(S, split_len)


def _decode_attention_split_merge(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                                  window: Optional[int] = None) -> torch.Tensor:
    """The earlier two-launch design (``decode_split`` + ``decode_merge``).
    No path of the port calls it: ``chip_smoke.py`` times it as the
    yardstick ``earlier_ms`` beside :func:`decode_attention_cuda`."""
    qp, kp = _checked(q, k, v, q_pos, kv_pos, window)
    B, _, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    split_len, n_split = _split_merge_plan(B, S, Hkv)
    out = torch.empty_like(q)
    part_ml = torch.empty(B * H * n_split * 2, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(B * H * n_split * Dh, dtype=torch.float32,
                           device=q.device)
    name = _ENTRY[q.dtype].replace("attention_", "attention_split_merge_")
    fn = getattr(_build.load("decode_attention", _SIGNATURES), name)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                kp.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
                part_acc.data_ptr(), B, S, H, Hkv, Dh, int(causal),
                0 if window is None else int(window), split_len, n_split,
                Dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    return out
