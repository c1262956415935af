"""Message framing for MPKLink channels (the port of ``repro.core.framing``).

A frame is a (rows, 128) uint32 tensor, byte for byte the reference's
layout, so a frame sealed by either package parses under the other:

  row 0   — header: [MAGIC, seed, seq, nbytes, dtype_code, ndim,
                     shape[0..3], deadline_us, mac^meta_mix, priority,
                     0...]
  rows 1+ — payload: raw bytes viewed as little-endian uint32, zero-padded
            to a whole number of 128-lane rows.

The MAC in the header is the tag-seeded 128-lane Horner hash of the payload
rows, XORed with a Horner mix of the twelve metadata words (lanes 0..10 and
the lane-12 priority), so flipping any header or payload bit fails
verification; reserved lanes 13..127 must be zero. Lane 10 carries the
sender's remaining deadline in microseconds (0 = none) and lane 12 its QoS
class (:data:`PRIO_NORMAL` / :data:`PRIO_HIGH` / :data:`PRIO_BULK`).

Frames live on a device. The MACs run where the frame lies, through
``kernels.ops``: sealing streams the payload through ``mac_init_state`` →
``mac_update`` → ``mac_finalize`` (:func:`fast_mac`); :func:`verify_view`
runs the receive-side guard
kernel ``guard_copy`` and hands back the payload from its protected copy;
:func:`seal_batch` / :func:`verify_batch` MAC a batch of frames with one
``mac_batch`` launch per row count. The header words are checked and
written on the host. Verified payloads are tensors on the frame's device.

Left out of this port (see ROADMAP.md): ``FrameArena``, ``STATS`` and the
``ZERO_COPY`` legacy paths.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import mpk_guard as _mg
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MAC_PRIME, MASK32

MAGIC = 0x4D504B4C            # "MPKL"
LANES = 128

DEADLINE_LANE = 10
DEADLINE_US_MAX = 0xFFFFFFFF

PRIORITY_LANE = 12
PRIO_NORMAL = 0
PRIO_HIGH = 1
PRIO_BULK = 2
_PRIO_MAX = PRIO_BULK

_DTYPES = {0: torch.float32, 1: torch.int32, 2: torch.uint32, 3: torch.uint8,
           4: torch.float64, 5: torch.int64, 6: torch.uint16}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


class FrameError(ValueError):
    pass


# ---------------------------------------------------------------------------
# MAC helpers
# ---------------------------------------------------------------------------

def _word(t: torch.Tensor) -> int:
    """A one-element uint32 tensor as a Python int (a host sync)."""
    return int(t.cpu().tolist()[0])


def fast_mac(payload_u32: torch.Tensor, seed: int,
             block_rows: int = 65536) -> int:
    """Payload MAC as init → one ``mac_update`` per ``block_rows`` rows →
    fold, on the payload's device (the reference's ``transports.fast_mac``).
    Any split gives the same word."""
    h = ops.mac_init_state(seed & MASK32, payload_u32.device)
    for s in range(0, payload_u32.shape[0], block_rows):
        h = ops.mac_update(h, payload_u32[s:s + block_rows])
    return _word(ops.mac_finalize(h))


def _meta_mix_words(words, seed: int) -> int:
    """Horner mix of the twelve MAC-covered header words (magic..deadline
    plus the lane-12 priority)."""
    h = (0x9E3779B9 ^ (seed & MASK32)) & MASK32
    for w in words:
        h = (h * MAC_PRIME + w) & MASK32
    return h


def _meta_mix(header: list, seed: int) -> int:
    """The meta mix of a header row given as a list of words."""
    return _meta_mix_words(header[:11] + [header[PRIORITY_LANE]], seed)


def mac_batch(payloads: Sequence[torch.Tensor], seed: int) -> List[int]:
    """Payload MACs for N (rows, 128) uint32 tensors on one device: frames
    are grouped by row count and each group is MAC'd by ``mac_batch``
    launches of at most ``mpk_guard.MAX_BATCH_FRAMES`` frames, so any N is
    taken, as the reference's numpy ``mac_batch`` takes it. A singleton
    group is passed as a view (no stacking copy)."""
    out: List[Optional[int]] = [None] * len(payloads)
    groups: Dict[int, List[int]] = {}
    for i, p in enumerate(payloads):
        groups.setdefault(p.shape[0], []).append(i)
    limit = _mg.MAX_BATCH_FRAMES
    chunks = [idx[c:c + limit] for idx in groups.values()
              for c in range(0, len(idx), limit)]
    for idx in chunks:
        if len(idx) == 1:
            stack = payloads[idx[0]][None]
        else:
            stack = torch.stack([payloads[i].view(torch.int32) for i in idx]
                                ).view(torch.uint32)
        macs = ops.mac_batch(stack, seed & MASK32).cpu().tolist()
        for j, i in enumerate(idx):
            out[i] = int(macs[j])
    return out


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.contiguous()
    a = np.ascontiguousarray(arr)
    try:
        return torch.from_numpy(a)
    except TypeError:
        raise FrameError(f"unsupported dtype {a.dtype}") from None


def _meta_of(t: torch.Tensor) -> dict:
    if t.dtype not in _DTYPE_CODES:
        raise FrameError(f"unsupported dtype {t.dtype}")
    if t.ndim > 4:
        raise FrameError("rank > 4 payloads unsupported by frame header")
    return {"dtype_code": _DTYPE_CODES[t.dtype],
            "nbytes": t.numel() * t.element_size(), "shape": tuple(t.shape)}


def _fill_payload(payload: torch.Tensor, t: torch.Tensor, nbytes: int) -> None:
    """Write ``t``'s bytes into the (rows, 128) uint32 ``payload`` and zero
    the pad tail (it is MAC-covered)."""
    pbytes = payload.reshape(-1).view(torch.uint8)
    if nbytes:
        pbytes[:nbytes] = t.reshape(-1).view(torch.uint8).to(payload.device)
    pbytes[nbytes:] = 0


def pack_payload(arr, *, device="cuda") -> Tuple[torch.Tensor, dict]:
    """array → ((rows, 128) uint32 on ``device``, meta), zero-padded."""
    t = _as_tensor(arr)
    meta = _meta_of(t)
    payload = torch.empty((frame_rows(meta["nbytes"]) - 1, LANES),
                          dtype=torch.uint32, device=resolve(device))
    _fill_payload(payload, t, meta["nbytes"])
    return payload, meta


def unpack_payload(payload_u32: torch.Tensor, meta: dict) -> torch.Tensor:
    """The payload's first ``nbytes`` bytes as a tensor of the frame's
    dtype and shape (a view of ``payload_u32``)."""
    raw = payload_u32.reshape(-1).view(torch.uint8)[: meta["nbytes"]]
    dtype = _DTYPES[meta["dtype_code"]]
    if dtype == torch.uint8 and len(meta["shape"]) == 1:
        return raw
    return raw.view(dtype).reshape(meta["shape"])


# ---------------------------------------------------------------------------
# seal
# ---------------------------------------------------------------------------

def _header(meta: dict, seed: int, seq: int, mac: int, deadline_us: int = 0,
            priority: int = 0) -> np.ndarray:
    """The 128-lane header row (reserved lanes zero)."""
    if len(meta["shape"]) > 4:
        raise FrameError("rank > 4 payloads unsupported by frame header")
    prio = int(priority)
    if not 0 <= prio <= _PRIO_MAX:
        raise FrameError(f"invalid priority class {priority}")
    shape = list(meta["shape"]) + [0] * (4 - len(meta["shape"]))
    words = [MAGIC, seed & MASK32, seq & MASK32, meta["nbytes"] & MASK32,
             meta["dtype_code"], len(meta["shape"]),
             *[s & MASK32 for s in shape], int(deadline_us) & MASK32]
    row = np.zeros(LANES, np.uint32)
    row[:13] = words + [(mac ^ _meta_mix_words(words + [prio], seed)) & MASK32,
                        prio]
    return row


def _write_header(frame: torch.Tensor, row: np.ndarray) -> None:
    frame[0].view(torch.int32).copy_(
        torch.from_numpy(row.view(np.int32)).to(frame.device))


def _check_buf(buf: torch.Tensor, rows: int) -> None:
    if (not isinstance(buf, torch.Tensor) or buf.ndim != 2
            or buf.shape[1] != LANES or buf.dtype != torch.uint32):
        raise FrameError("seal buffer must be a (rows, 128) uint32 tensor")
    if not buf.is_contiguous():
        raise FrameError("seal buffer must be contiguous")
    if buf.shape[0] < rows:
        raise FrameError(f"seal buffer too small ({buf.shape[0]} rows for a "
                         f"{rows}-row frame)")


def seal_into(buf: torch.Tensor, arr, *, seed: int, seq: int,
              deadline_us: int = 0, priority: int = 0) -> int:
    """Seal ``arr`` as a frame directly into ``buf`` (a contiguous
    (>= frame_rows, 128) uint32 tensor; written in place): payload bytes,
    zeroed pad tail, MAC over the payload in place, header last. Returns
    the rows used; ``buf[rows:]`` is untouched."""
    t = _as_tensor(arr)
    meta = _meta_of(t)
    rows = frame_rows(meta["nbytes"])
    _check_buf(buf, rows)
    payload = buf[1:rows]
    _fill_payload(payload, t, meta["nbytes"])
    mac = fast_mac(payload, seed)
    _write_header(buf, _header(meta, seed, seq, mac, deadline_us, priority))
    return rows


def build_frame(arr, *, seed: int, seq: int, deadline_us: int = 0,
                priority: int = 0, device="cuda") -> torch.Tensor:
    """array → a fresh frame (header row + payload rows) on ``device``."""
    t = _as_tensor(arr)
    frame = torch.empty((frame_rows(_meta_of(t)["nbytes"]), LANES),
                        dtype=torch.uint32, device=resolve(device))
    seal_into(frame, t, seed=seed, seq=seq, deadline_us=deadline_us,
              priority=priority)
    return frame


def seal_batch(arrays: Sequence, *, seed: int, start_seq: Optional[int] = None,
               seqs: Optional[Sequence[int]] = None,
               priorities: Optional[Sequence[int]] = None,
               device="cuda") -> List[torch.Tensor]:
    """Frame N messages on ``device``, MAC'ing the payloads with one
    ``mac_batch`` launch per row count. Sequence numbers come from
    ``start_seq`` (consecutive) or an explicit ``seqs`` list."""
    if seqs is None:
        if start_seq is None:
            raise ValueError("seal_batch needs start_seq or seqs")
        seqs = [start_seq + i for i in range(len(arrays))]
    if priorities is None:
        priorities = [PRIO_NORMAL] * len(arrays)
    dev = resolve(device)
    tensors = [_as_tensor(a) for a in arrays]
    metas = [_meta_of(t) for t in tensors]
    frames = [torch.empty((frame_rows(m["nbytes"]), LANES), dtype=torch.uint32,
                          device=dev) for m in metas]
    for f, t, m in zip(frames, tensors, metas):
        _fill_payload(f[1:], t, m["nbytes"])
    macs = mac_batch([f[1:] for f in frames], seed)
    for f, m, seq, mac, prio in zip(frames, metas, seqs, macs, priorities):
        _write_header(f, _header(m, seed, seq, mac, 0, prio))
    return frames


# ---------------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------------

def _check_shape(frame) -> None:
    if (not isinstance(frame, torch.Tensor) or frame.ndim != 2
            or frame.shape[0] < 1 or frame.shape[1] != LANES
            or frame.dtype != torch.uint32):
        raise FrameError("malformed frame — truncated or not lane-aligned")
    if not frame.is_contiguous():
        raise FrameError("frame must be contiguous")


def _precheck(header: list, seed: int, expect_seq) -> None:
    """The cheap receive-side rejects (no MAC): magic, seed, sequence,
    priority class, reserved lanes."""
    if header[0] != MAGIC:
        raise FrameError("bad magic — not an MPKLink frame")
    if header[1] != (seed & MASK32):
        raise FrameError("seed mismatch — wrong domain key, session or epoch")
    if expect_seq is not None and header[2] != (expect_seq & MASK32):
        raise FrameError(f"sequence mismatch (got {header[2]}, want {expect_seq})")
    if header[PRIORITY_LANE] > _PRIO_MAX:
        raise FrameError("invalid priority class — header tampered")
    if any(header[13:]):
        raise FrameError("nonzero reserved header lanes — header tampered")


def _expected_mac(header: list, seed: int) -> int:
    """The payload MAC the header vouches for: stored word ^ meta mix."""
    return (header[11] ^ _meta_mix(header, seed)) & MASK32


def _check_fields(header: list, n_rows: int) -> dict:
    """Metadata checks after the MAC passed → the validated meta."""
    ndim, nbytes, dtype_code = header[5], header[3], header[4]
    if dtype_code not in _DTYPES or ndim > 4:
        raise FrameError("invalid header metadata (dtype/ndim)")
    shape = tuple(header[6:6 + ndim])
    itemsize = _DTYPES[dtype_code].itemsize
    if math.prod(shape) * itemsize != nbytes:
        raise FrameError("invalid header metadata (shape/nbytes disagree)")
    if n_rows != frame_rows(nbytes):
        raise FrameError(f"frame length mismatch ({n_rows - 1} payload rows "
                         f"for {nbytes} bytes)")
    return {"dtype_code": dtype_code, "nbytes": nbytes, "shape": shape}


def verify_view(frame: torch.Tensor, *, seed: int,
                expect_seq=None) -> torch.Tensor:
    """The full receive-side guard: header prechecks, then the
    ``guard_copy`` kernel (MAC + protected copy of the payload in one
    pass), then the metadata checks. Returns the payload as a tensor of
    the frame's dtype and shape, a view of the guarded copy (so later
    writes to ``frame`` cannot reach it). Raises :class:`FrameError`."""
    _check_shape(frame)
    header = frame[0].cpu().tolist()
    _precheck(header, seed, expect_seq)
    copy, _, ok = ops.guard_copy(frame[1:], seed & MASK32,
                                 _expected_mac(header, seed))
    if not int(ok.cpu().tolist()[0]):
        raise FrameError("MAC mismatch — payload or header tampered/truncated")
    return unpack_payload(copy, _check_fields(header, frame.shape[0]))


# In the port both receive paths return the guarded copy.
parse_frame = verify_view


def verify_batch(frames: Sequence[torch.Tensor], *, seed: int,
                 seqs: Optional[Sequence[int]] = None,
                 start_seq: Optional[int] = None,
                 strict: bool = True) -> List[Union[torch.Tensor, FrameError]]:
    """Receive-side guard for N frames with one ``mac_batch`` launch per
    row count. With ``strict=True`` the first bad frame raises (message
    prefixed with its batch index); with ``strict=False`` the list carries
    the ``FrameError`` in that frame's position. Payloads are views of the
    frames."""
    if seqs is None and start_seq is not None:
        seqs = [start_seq + i for i in range(len(frames))]
    out: List[Union[torch.Tensor, FrameError, None]] = [None] * len(frames)
    headers: Dict[int, list] = {}
    for i, f in enumerate(frames):
        try:
            _check_shape(f)
            headers[i] = f[0].cpu().tolist()
            _precheck(headers[i], seed, None if seqs is None else seqs[i])
        except FrameError as e:
            if strict:
                raise FrameError(f"frame {i}: {e}") from None
            out[i] = e
            headers.pop(i, None)
    candidates = list(headers)
    macs = mac_batch([frames[i][1:] for i in candidates], seed)
    for i, mac in zip(candidates, macs):
        try:
            if mac != _expected_mac(headers[i], seed):
                raise FrameError(
                    "MAC mismatch — payload or header tampered/truncated")
            meta = _check_fields(headers[i], frames[i].shape[0])
            out[i] = unpack_payload(frames[i][1:], meta)
        except FrameError as e:
            if strict:
                raise FrameError(f"frame {i}: {e}") from None
            out[i] = e
    return out


# ---------------------------------------------------------------------------
# frame walking and header lanes
# ---------------------------------------------------------------------------

def split_frames(flat_u32: torch.Tensor,
                 max_frames: int = 4096) -> List[torch.Tensor]:
    """Carve a row-concatenation of frames back into individual frames
    (views). Each header's ``nbytes`` gives its frame's length; a corrupted
    length desyncs the walk and raises ``FrameError``."""
    if (not isinstance(flat_u32, torch.Tensor) or flat_u32.ndim != 2
            or flat_u32.shape[1] != LANES):
        raise FrameError("malformed frame concatenation — not lane-aligned")
    words = flat_u32.view(torch.int32)[:, :4].cpu().numpy().view(np.uint32)
    frames: List[torch.Tensor] = []
    row = 0
    while row < flat_u32.shape[0]:
        if len(frames) >= max_frames:
            raise FrameError(f"more than {max_frames} frames in one batch")
        if int(words[row, 0]) != MAGIC:
            raise FrameError(
                f"bad magic at row {row} — frame walk desynced (corrupted "
                f"length in an earlier header?)")
        rows = frame_rows(int(words[row, 3]))
        if row + rows > flat_u32.shape[0]:
            raise FrameError(
                f"frame at row {row} declares {rows} rows but only "
                f"{flat_u32.shape[0] - row} remain")
        frames.append(flat_u32[row: row + rows])
        row += rows
    return frames


def frame_rows(nbytes: int) -> int:
    """Total frame rows (header + payload) for an nbytes message."""
    return 1 + (nbytes + LANES * 4 - 1) // (LANES * 4)


def frame_deadline_us(frame: torch.Tensor) -> int:
    """The lane-10 deadline word (0 = none); meaningful only after the
    frame passed verification (the word is MAC-covered)."""
    return int(frame[0, :PRIORITY_LANE + 1].cpu().tolist()[DEADLINE_LANE])


def frame_priority(frame: torch.Tensor) -> int:
    """The lane-12 priority word; meaningful only after verification."""
    return int(frame[0, :PRIORITY_LANE + 1].cpu().tolist()[PRIORITY_LANE])


def deadline_to_us(remaining_s: Optional[float]) -> int:
    """A remaining budget in seconds as the lane-10 wire word: None → 0
    (no deadline), expired → 1 µs, saturating at :data:`DEADLINE_US_MAX`."""
    if remaining_s is None:
        return 0
    us = int(remaining_s * 1e6)
    if us <= 0:
        return 1
    return min(us, DEADLINE_US_MAX)
