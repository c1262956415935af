"""mpk_guard — the MPKLink guard MAC: CUDA kernels and their plain versions.

The port of ``repro.kernels.mpk_guard``. The channel's domain ``tag`` seeds
a 128-lane Horner MAC (``h = h·P + row``, h0 = INIT + tag) that is folded
to one uint32 word by Σ h_i·P^(127-i):

* :func:`guard_copy_cuda` — the receive-side protected copy: copies the
  payload and computes its MAC in the same pass, ``ok = mac == expected``;
* :func:`mac_batch_cuda` — N frames of equal row count MAC'd together;
* :func:`mac_init_state_cuda` / :func:`mac_update_cuda` /
  :func:`mac_finalize_cuda` — the streaming form: an explicit (128,) state
  advanced block by block, so any split of a payload gives the one-shot MAC.

``guard_copy``, ``mac_batch`` and ``mac_update`` are one launch a call:
their blocks read the payload in 16-byte pieces, and where a call spans
many blocks the last one to arrive merges the partials (which, with the
arrival counters, live in ``workspace``; so the rule of that module holds:
call each once eagerly at a shape before capturing it in a CUDA graph).
Their payloads must start 16-byte aligned and be contiguous.

Each ``*_cuda`` function launches the kernel of ``csrc/mpk_guard.cu`` on the
current stream (it raises for anything the kernel does not take); each
``*_plain`` function is the same computation in plain PyTorch (int64 with
32-bit masking, see ``ref``). ``kernels.ops`` picks one by the tensor's
device and counts the launches. Tags and expected MACs are Python ints.
:func:`_guard_copy_two_pass`, :func:`_mac_batch_two_pass` and
:func:`_mac_update_two_pass` are the earlier two-launch designs:
``chip_smoke.py`` times them as yardsticks, and the two MACs run the
legacy copy plane (``framing.ZERO_COPY = False``, through
``ops.mac_batch_two_pass`` / ``ops.mac_update_two_pass``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels import workspace
from repro_torch.kernels.ref import LANES, MAC_INIT, MASK32

GUARD_CHUNK_ROWS = 128  # payload rows per CUDA block of guard_copy
MAC_CHUNK_ROWS = 256    # payload rows per CUDA block of mac_batch / mac_update
MAC_THREADS = 512       # most threads per block of mac_batch / mac_update
TWO_PASS_CHUNK_ROWS = 64  # rows per block of the earlier two-launch designs
MAX_BATCH_FRAMES = 65535  # frames per mac_batch launch (the kernel's grid y)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_U32 = ctypes.c_uint32
_INT = ctypes.c_int
_SIGNATURES = {
    "mpk_guard_copy": (_P, _P, _P, _P, _P, _I64, _I64, _U32, _U32, _P),
    "mpk_guard_copy_two_pass": (_P, _P, _P, _P, _P, _I64, _I64, _U32, _U32, _P),
    "mpk_mac_batch": (_P, _P, _P, _P, _I64, _I64, _I64, _INT, _U32, _P),
    "mpk_mac_batch_two_pass": (_P, _P, _P, _I64, _I64, _I64, _U32, _P),
    "mpk_mac_update": (_P, _P, _P, _P, _I64, _I64, _INT, _P),
    "mpk_mac_update_two_pass": (_P, _P, _P, _P, _I64, _I64, _P),
    "mpk_mac_init": (_P, _U32, _P),
    "mpk_mac_finalize": (_P, _P, _P),
}


# ---------------------------------------------------------------------------
# costs: the work of one call (128 multiply-adds a 128-word row), in the
# integer ops the roofline counts at the f32 peak
# ---------------------------------------------------------------------------

def cost(kernel: str, words: torch.Tensor) -> dict:
    """The work of one call of ``kernel`` on ``words`` (guard_copy's
    payload, mac_batch's stack, mac_update's block; mac_init_state and
    mac_finalize take the (128,) state): every payload word read once, the
    copy, MACs and flags or the state written once."""
    n = words.numel()
    nbytes = {"guard_copy": 8 * n + 12, "mac_batch": 4 * n + 4 * words.shape[0],
              "mac_update": 4 * n + 2 * 4 * LANES, "mac_init_state": 4 * LANES,
              "mac_finalize": 4 * LANES + 4}[kernel]
    flops = LANES if kernel == "mac_init_state" else 2 * n
    return {"flops": flops, "bytes": nbytes, "dtype": torch.float32}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def guard_copy_plain(payload_u32: torch.Tensor, tag: int, expected_mac: int):
    """(copy, mac (1,) uint32, ok (1,) int32)."""
    return ref.guard_copy_ref(payload_u32, tag, expected_mac)


def mac_batch_plain(stack_u32: torch.Tensor, tag: int) -> torch.Tensor:
    """(N, rows, 128) uint32 → (N,) uint32 MACs."""
    h0 = torch.full((stack_u32.shape[0], LANES), (MAC_INIT + tag) & MASK32,
                    dtype=torch.int64, device=stack_u32.device)
    return ref.fold_lanes(ref.mac_state(stack_u32, h0)).to(torch.uint32)


def mac_init_state_plain(tag: int, device) -> torch.Tensor:
    """Fresh (128,) uint32 Horner state for ``tag``."""
    return torch.full((LANES,), (MAC_INIT + tag) & MASK32, dtype=torch.int64,
                      device=device).to(torch.uint32)


def mac_update_plain(h: torch.Tensor, block_u32: torch.Tensor) -> torch.Tensor:
    """h·P^m + Σ_r row_r·P^(m-1-r) for an (m, 128) block → (128,) uint32."""
    return ref.mac_state(block_u32, h.to(torch.int64)).to(torch.uint32)


def mac_finalize_plain(h: torch.Tensor) -> torch.Tensor:
    """Fold a (128,) state to the MAC word → (1,) uint32."""
    return ref.fold_lanes(h.to(torch.int64)).reshape(1).to(torch.uint32)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def _lib():
    return _build.load("mpk_guard", _SIGNATURES)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(t: torch.Tensor, ndim: int, what: str) -> None:
    if (not t.is_cuda or t.dtype != torch.uint32 or t.ndim != ndim
            or t.shape[-1] != LANES or not t.is_contiguous()):
        raise ValueError(f"{what}: needs a contiguous CUDA uint32 tensor of "
                         f"{ndim} dims with {LANES} lanes, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _aligned(t: torch.Tensor, what: str) -> int:
    """The data pointer of ``t``, which must start 16-byte aligned."""
    ptr = t.data_ptr()
    if ptr % 16:
        raise ValueError(f"{what}: the payload must start 16-byte aligned")
    return ptr


def mac_threads(rows: int, chunk: int = None, most: int = None) -> int:
    """Threads per block of mac_batch / mac_update for ``rows`` rows a
    frame: a warp per 8 rows of a chunk, from 4 warps (a one-row call) to
    ``most`` // 32 (``MAC_THREADS``; chunks of ``MAC_CHUNK_ROWS``)."""
    chunk = MAC_CHUNK_ROWS if chunk is None else chunk
    most = MAC_THREADS if most is None else most
    return 32 * min(most // 32, max(4, _cdiv(min(rows, chunk), 8)))


def _launch(dev: int, fn, *args) -> int:
    """``fn(*args)`` with ``dev`` the current device (entered only when it
    is not already)."""
    if dev == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def guard_copy_cuda(payload_u32: torch.Tensor, tag: int, expected_mac: int):
    """(copy, mac (1,) uint32, ok (1,) int32) from one kernel launch; the
    payload must start 16-byte aligned. ``mac`` and ``ok`` are views of one
    two-word buffer."""
    _check_rows(payload_u32, 2, "guard_copy")
    src = _aligned(payload_u32, "guard_copy")
    rows = payload_u32.shape[0]
    dev = payload_u32.get_device()
    stream = workspace.current_stream(dev)
    counter, partials = workspace.scratch(
        "guard_copy", dev, stream, counters=1, nbytes=4 * _cdiv(rows, GUARD_CHUNK_ROWS))
    copy = torch.empty_like(payload_u32)
    mac_ok = torch.empty(2, dtype=torch.int32, device=payload_u32.device)
    rc = _launch(dev, _lib().mpk_guard_copy, src, copy.data_ptr(), partials, counter,
                 mac_ok.data_ptr(), rows, GUARD_CHUNK_ROWS, tag & MASK32,
                 expected_mac & MASK32, stream)
    _build.check(rc, "mpk_guard_copy")
    mac, ok = mac_ok.split(1)
    return copy, mac.view(torch.uint32), ok


def _guard_copy_two_pass(payload_u32: torch.Tensor, tag: int, expected_mac: int):
    """The earlier two-launch guard_copy (one thread per lane, 4-byte
    accesses, a second launch for the sum). No path of the port calls it:
    ``chip_smoke.py`` times it as the yardstick ``earlier_ms``."""
    _check_rows(payload_u32, 2, "guard_copy")
    rows = payload_u32.shape[0]
    dev = payload_u32.device
    copy = torch.empty_like(payload_u32)
    partials = torch.empty(max(1, _cdiv(rows, TWO_PASS_CHUNK_ROWS)), dtype=torch.uint32,
                           device=dev)
    mac = torch.empty(1, dtype=torch.uint32, device=dev)
    ok = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().mpk_guard_copy_two_pass(
            payload_u32.data_ptr(), copy.data_ptr(), partials.data_ptr(),
            mac.data_ptr(), ok.data_ptr(), rows, TWO_PASS_CHUNK_ROWS, tag & MASK32,
            expected_mac & MASK32, _stream(payload_u32))
    _build.check(rc, "mpk_guard_copy_two_pass")
    return copy, mac, ok


def mac_batch_cuda(stack_u32: torch.Tensor, tag: int) -> torch.Tensor:
    """(N, rows, 128) uint32 → (N,) uint32 MACs, one launch; the stack must
    start 16-byte aligned."""
    _check_rows(stack_u32, 3, "mac_batch")
    src = _aligned(stack_u32, "mac_batch")
    frames, rows = stack_u32.shape[0], stack_u32.shape[1]
    if not 0 < frames <= MAX_BATCH_FRAMES:
        raise ValueError(f"mac_batch: 1..{MAX_BATCH_FRAMES} frames per launch, "
                         f"got {frames}")
    dev = stack_u32.get_device()
    stream = workspace.current_stream(dev)
    counters, partials = workspace.scratch(
        "mac_batch", dev, stream, counters=frames,
        nbytes=4 * frames * _cdiv(rows, MAC_CHUNK_ROWS))
    macs = torch.empty(frames, dtype=torch.uint32, device=stack_u32.device)
    rc = _launch(dev, _lib().mpk_mac_batch, src, partials, counters, macs.data_ptr(),
                 frames, rows, MAC_CHUNK_ROWS, mac_threads(rows), tag & MASK32, stream)
    _build.check(rc, "mpk_mac_batch")
    return macs


def _mac_batch_two_pass(stack_u32: torch.Tensor, tag: int) -> torch.Tensor:
    """The earlier two-launch mac_batch (one thread per lane, 4-byte
    accesses, a second launch for the sums): the legacy copy plane's
    ``mac_batch`` (``ops.mac_batch_two_pass``) and ``chip_smoke.py``'s
    yardstick ``earlier_ms``."""
    _check_rows(stack_u32, 3, "mac_batch")
    frames, rows = stack_u32.shape[0], stack_u32.shape[1]
    if not 0 < frames <= MAX_BATCH_FRAMES:
        raise ValueError(f"mac_batch: 1..{MAX_BATCH_FRAMES} frames per launch, "
                         f"got {frames}")
    dev = stack_u32.device
    partials = torch.empty(max(1, frames * _cdiv(rows, TWO_PASS_CHUNK_ROWS)),
                           dtype=torch.uint32, device=dev)
    macs = torch.empty(frames, dtype=torch.uint32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().mpk_mac_batch_two_pass(
            stack_u32.data_ptr(), partials.data_ptr(), macs.data_ptr(), frames, rows,
            TWO_PASS_CHUNK_ROWS, tag & MASK32, _stream(stack_u32))
    _build.check(rc, "mpk_mac_batch_two_pass")
    return macs


def mac_init_state_cuda(tag: int, device) -> torch.Tensor:
    """Fresh (128,) uint32 Horner state for ``tag`` on a CUDA device."""
    out = torch.empty(LANES, dtype=torch.uint32, device=device)
    if out.device.type != "cuda":
        raise ValueError(f"mac_init_state: CUDA device required, got {device}")
    with torch.cuda.device(out.device):
        rc = _lib().mpk_mac_init(out.data_ptr(), tag & MASK32, _stream(out))
    _build.check(rc, "mpk_mac_init")
    return out


def _check_state(h: torch.Tensor, block_u32: torch.Tensor) -> None:
    _check_rows(block_u32, 2, "mac_update block")
    _check_rows(h, 1, "mac_update state")
    if h.device != block_u32.device:
        raise ValueError(f"mac_update: state on {h.device}, block on {block_u32.device}")


def mac_update_cuda(h: torch.Tensor, block_u32: torch.Tensor) -> torch.Tensor:
    """Advance a (128,) uint32 state over an (m, 128) block (m may be 0) in
    one launch; the block must start 16-byte aligned."""
    _check_state(h, block_u32)
    src = _aligned(block_u32, "mac_update")
    rows = block_u32.shape[0]
    dev = block_u32.get_device()
    stream = workspace.current_stream(dev)
    counters, _ = workspace.scratch("mac_update", dev, stream, counters=1 + LANES, nbytes=0)
    out = torch.empty(LANES, dtype=torch.uint32, device=block_u32.device)
    rc = _launch(dev, _lib().mpk_mac_update, h.data_ptr(), src, counters, out.data_ptr(),
                 rows, MAC_CHUNK_ROWS, mac_threads(rows), stream)
    _build.check(rc, "mpk_mac_update")
    return out


def _mac_update_two_pass(h: torch.Tensor, block_u32: torch.Tensor) -> torch.Tensor:
    """The earlier two-launch mac_update (one thread per lane, 4-byte
    accesses, a one-block second launch that sums the chunk partials
    serially per lane): the legacy copy plane's ``mac_update``
    (``ops.mac_update_two_pass``) and ``chip_smoke.py``'s yardstick
    ``earlier_ms``."""
    _check_state(h, block_u32)
    rows = block_u32.shape[0]
    dev = block_u32.device
    partials = torch.empty(max(1, _cdiv(rows, TWO_PASS_CHUNK_ROWS)) * LANES,
                           dtype=torch.uint32, device=dev)
    out = torch.empty(LANES, dtype=torch.uint32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().mpk_mac_update_two_pass(h.data_ptr(), block_u32.data_ptr(),
                                            partials.data_ptr(), out.data_ptr(), rows,
                                            TWO_PASS_CHUNK_ROWS, _stream(block_u32))
    _build.check(rc, "mpk_mac_update_two_pass")
    return out


def mac_finalize_cuda(h: torch.Tensor) -> torch.Tensor:
    """Fold a (128,) uint32 state to the MAC word → (1,) uint32."""
    _check_rows(h, 1, "mac_finalize state")
    mac = torch.empty(1, dtype=torch.uint32, device=h.device)
    with torch.cuda.device(h.device):
        rc = _lib().mpk_mac_finalize(h.data_ptr(), mac.data_ptr(), _stream(h))
    _build.check(rc, "mpk_mac_finalize")
    return mac
