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
:func:`seal_batch` / :func:`seal_into_batch` / :func:`verify_batch` MAC a
batch of frames with one ``mac_batch`` launch per row count. The header
words are checked and written on the host. Verified payloads are tensors
on the frame's device.

:func:`seal_into` and :func:`seal_into_batch` seal straight into a caller's
buffer (a :class:`FrameArena` slot or a transport's region), and
:func:`seal_prefilled` seals a payload the caller already wrote there.
:data:`STATS` counts what the data plane does (frames sealed and verified,
bytes the framing layer writes, arena traffic, doorbell wakeups, key
syncs), exact under concurrent writers.

:data:`ZERO_COPY` (the reference's switch, True by default) set to False
routes the build paths through the legacy copy plane, the A/B yardstick of
the in-place one: :func:`build_frame` pads and heads its frame with two
``torch.cat`` on the frame's device (:func:`_build_frame_legacy`), the
transports and the gateway copy such frames into their region, ring slot
or envelope, and the MACs run the earlier two-launch kernels
(``ops.mac_update_two_pass`` / ``ops.mac_batch_two_pass``). The frames are
bit-identical and verify the same either way; only a caller flips it.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import mpk_guard as _mg
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MAC_PRIME, MASK32

MAGIC = 0x4D504B4C            # "MPKL"
LANES = 128

# Benchmark switch (the reference's name and meaning): False selects the
# legacy copy plane and the two-launch MAC kernels. Nothing sets it but a
# caller; no error switches to it or away from it.
ZERO_COPY = True

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
# data-plane counters
# ---------------------------------------------------------------------------

class FrameStats:
    """Process-wide framing + data-plane counters (the reference's
    ``FrameStats``). ``bytes_copied`` counts every payload byte the framing
    layer writes (the seal's payload write, the guard's protected copy,
    and in the legacy copy plane its staging: the pad and header
    concatenations, the packed and assembled frames of a legacy batch);
    ``concat_calls`` counts the legacy plane's ``torch.cat`` calls on the
    frame path, as the reference counts its ``np.concatenate`` calls: 0
    with :data:`ZERO_COPY`, at least one a frame without it.

    The transports account their signalling here too: ``wakeups`` counts
    doorbell rings, ``doorbell_parks`` waits that parked after the bounded
    spin, and ``key_syncs`` PKRU synchronization round trips.

    Counters are sharded per thread (each thread owns a private dict,
    registered once under a lock), so :meth:`bump` takes no lock and can
    never lose an increment; :meth:`snapshot` sums the shards, exact once
    the counting threads have quiesced. Shards of dead threads are folded
    into a retired base, so a process cycling many session threads does
    not accumulate them. Reading a field attribute sums the shards too."""

    _FIELDS = ("frames_sealed", "frames_sealed_inplace", "frames_verified",
               "views_returned", "bytes_copied", "concat_calls",
               "arena_allocated", "arena_reused", "arena_released",
               "wakeups", "doorbell_parks", "key_syncs")

    def __init__(self):
        self._rlock = threading.Lock()      # guards the shard registry only
        self._local = threading.local()
        self._shards: List[Tuple[threading.Thread, Dict[str, int]]] = []
        self._retired: Dict[str, int] = dict.fromkeys(self._FIELDS, 0)

    def _shard(self) -> Dict[str, int]:
        d = getattr(self._local, "d", None)
        if d is None:
            d = dict.fromkeys(self._FIELDS, 0)
            self._local.d = d
            with self._rlock:
                self._shards.append((threading.current_thread(), d))
        return d

    def _fold_dead_locked(self) -> None:
        live = []
        for th, d in self._shards:
            if th.is_alive():
                live.append((th, d))
            else:                       # no further bumps possible: fold
                for f in self._FIELDS:
                    self._retired[f] += d[f]
        self._shards = live

    def bump(self, **deltas: int) -> None:
        """Add each delta to its counter (lock-free: a per-thread shard);
        unknown counter names raise KeyError."""
        d = getattr(self._local, "d", None)
        if d is None:
            d = self._shard()
        for name, delta in deltas.items():
            d[name] += delta            # KeyError on unknown fields

    def reset(self):
        with self._rlock:
            self._fold_dead_locked()
            self._retired = dict.fromkeys(self._FIELDS, 0)
            shards = [d for _, d in self._shards]
        for d in shards:
            for f in self._FIELDS:
                d[f] = 0

    def snapshot(self) -> Dict[str, int]:
        with self._rlock:
            self._fold_dead_locked()
            out = dict(self._retired)
            shards = [d for _, d in self._shards]
        for d in shards:
            for f in self._FIELDS:
                out[f] += d[f]
        return out

    def __getattr__(self, name: str):
        if not name.startswith("_") and name in FrameStats._FIELDS:
            return self.snapshot()[name]
        raise AttributeError(name)


STATS = FrameStats()


# ---------------------------------------------------------------------------
# MAC helpers
# ---------------------------------------------------------------------------

def _word(t: torch.Tensor) -> int:
    """A one-element uint32 tensor as a Python int (a host sync)."""
    return int(t.cpu().tolist()[0])


FAST_MAC_BLOCK_ROWS = 65536   # payload rows per mac_update launch of a seal


def fast_mac(payload_u32: torch.Tensor, seed: int,
             block_rows: int = FAST_MAC_BLOCK_ROWS) -> int:
    """Payload MAC as init → one ``mac_update`` per ``block_rows`` rows →
    fold, on the payload's device (the reference's ``transports.fast_mac``).
    Any split gives the same word. Without :data:`ZERO_COPY` it is
    :func:`legacy_fast_mac`."""
    if not ZERO_COPY:
        return legacy_fast_mac(payload_u32, seed, block_rows)
    h = ops.mac_init_state(seed & MASK32, payload_u32.device)
    for s in range(0, payload_u32.shape[0], block_rows):
        h = ops.mac_update(h, payload_u32[s:s + block_rows])
    return _word(ops.mac_finalize(h))


def legacy_fast_mac(payload_u32: torch.Tensor, seed: int,
                    block_rows: int = FAST_MAC_BLOCK_ROWS) -> int:
    """The legacy plane's payload MAC (the reference's ``legacy_fast_mac``):
    the streaming MAC with each block through the earlier two-launch
    ``mac_update`` (``ops.mac_update_two_pass``). The same word as
    :func:`fast_mac`'s."""
    h = ops.mac_init_state(seed & MASK32, payload_u32.device)
    for s in range(0, payload_u32.shape[0], block_rows):
        h = ops.mac_update_two_pass(h, payload_u32[s:s + block_rows])
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
    group is passed as a view (no stacking copy). Without
    :data:`ZERO_COPY` each launch is the earlier two-launch design
    (``ops.mac_batch_two_pass``), with the same words."""
    launch = ops.mac_batch if ZERO_COPY else ops.mac_batch_two_pass
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
        macs = launch(stack, seed & MASK32).cpu().tolist()
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
    """Write ``t``'s bytes into the (rows, 128) uint32 ``payload`` (one copy,
    across devices where ``t`` lies elsewhere) and zero the pad tail (it is
    MAC-covered)."""
    pbytes = payload.reshape(-1).view(torch.uint8)
    if nbytes:
        pbytes[:nbytes].copy_(t.reshape(-1).view(torch.uint8))
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


def _write_headers(bufs: Sequence[torch.Tensor], rows: List[np.ndarray]) -> None:
    """Row 0 of each buffer from its header row, with one host-to-device
    copy for the lot (a device-side copy into each buffer)."""
    if not bufs:
        return
    src = torch.from_numpy(np.stack(rows).view(np.int32)).to(bufs[0].device)
    for buf, row in zip(bufs, src):
        buf[0].view(torch.int32).copy_(row)


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
              deadline_us: int = 0, priority: int = 0,
              _inplace: bool = True) -> int:
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
    STATS.bump(frames_sealed=1, bytes_copied=meta["nbytes"],
               frames_sealed_inplace=int(_inplace))
    return rows


def seal_into_batch(bufs: Sequence[torch.Tensor], arrays: Sequence, *,
                    seed: int, seqs: Sequence[int],
                    deadlines_us: Optional[Sequence[int]] = None,
                    priorities: Optional[Sequence[int]] = None) -> List[int]:
    """Seal N frames in place, each into its ``bufs[i]``, with the payload
    MACs of one ``mac_batch`` launch per row count (the arena twin of
    :func:`seal_batch`). Returns the rows used per frame."""
    tensors = [_as_tensor(a) for a in arrays]
    metas = [_meta_of(t) for t in tensors]
    rows_list = [frame_rows(m["nbytes"]) for m in metas]
    payloads = []
    for buf, t, meta, rows in zip(bufs, tensors, metas, rows_list):
        _check_buf(buf, rows)
        payloads.append(buf[1:rows])
        _fill_payload(payloads[-1], t, meta["nbytes"])
    macs = mac_batch(payloads, seed)
    n = len(tensors)
    deadlines_us = [0] * n if deadlines_us is None else deadlines_us
    priorities = [PRIO_NORMAL] * n if priorities is None else priorities
    _write_headers(bufs, [_header(m, seed, q, mac, dl, pr) for m, q, mac, dl, pr
                          in zip(metas, seqs, macs, deadlines_us, priorities)])
    STATS.bump(frames_sealed=n, frames_sealed_inplace=n,
               bytes_copied=sum(m["nbytes"] for m in metas))
    return rows_list


def seal_prefilled(buf: torch.Tensor, nbytes: int, *, seed: int, seq: int,
                   deadline_us: int = 0, priority: int = 0) -> int:
    """Seal a frame whose ``nbytes`` payload bytes the caller already wrote
    into ``buf[1:]`` (viewed as bytes): zero the pad tail, MAC in place,
    write the header. The frame is a flat uint8 payload of ``nbytes``
    bytes, bit for bit ``seal_into(buf, <those bytes>, ...)``."""
    rows = frame_rows(nbytes)
    _check_buf(buf, rows)
    payload = buf[1:rows]
    payload.reshape(-1).view(torch.uint8)[nbytes:] = 0
    mac = fast_mac(payload, seed)
    meta = {"dtype_code": _DTYPE_CODES[torch.uint8], "nbytes": int(nbytes),
            "shape": (int(nbytes),)}
    _write_header(buf, _header(meta, seed, seq, mac, deadline_us, priority))
    STATS.bump(frames_sealed=1, frames_sealed_inplace=1)
    return rows


def _on_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t``'s bytes, flat, on the frame's device and 4-byte aligned: a
    staging copy (counted) only for bytes that lie elsewhere or start
    misaligned, so the legacy plane's MACs run where its frame lies."""
    if not t.numel():
        return torch.empty(0, dtype=torch.uint8, device=dev)
    raw = t.reshape(-1).view(torch.uint8)
    if raw.device == dev and raw.storage_offset() % 4 == 0:
        return raw
    STATS.bump(bytes_copied=raw.numel())
    return raw.to(dev, copy=True)


def _build_frame_legacy(t: torch.Tensor, *, seed: int, seq: int,
                        deadline_us: int, priority: int,
                        dev: torch.device) -> torch.Tensor:
    """The legacy copy pattern (the reference's ``_build_frame_legacy``):
    a ``torch.cat`` for the pad when there is one, the MAC over the padded
    payload, a ``torch.cat`` of the header row and the payload. The same
    bytes as the in-place seal, with 3-4x its copies."""
    meta = _meta_of(t)
    raw = _on_device(t, dev)
    pad = (-raw.numel()) % (LANES * 4)
    if pad:
        raw = torch.cat([raw, torch.zeros(pad, dtype=torch.uint8, device=dev)])
        STATS.bump(concat_calls=1, bytes_copied=raw.numel())
    payload = raw.view(torch.int32).reshape(-1, LANES)
    mac = legacy_fast_mac(payload.view(torch.uint32), seed)
    header = torch.from_numpy(_header(meta, seed, seq, mac, deadline_us,
                                      priority).view(np.int32)).to(dev)
    STATS.bump(concat_calls=1, frames_sealed=1,
               bytes_copied=payload.numel() * 4 + LANES * 4)
    return torch.cat([header[None], payload]).view(torch.uint32)


def build_frame(arr, *, seed: int, seq: int, deadline_us: int = 0,
                priority: int = 0, device="cuda") -> torch.Tensor:
    """array → a fresh frame (header row + payload rows) on ``device``:
    one buffer and one payload write, or without :data:`ZERO_COPY` the
    legacy concatenations (the same bytes)."""
    t = _as_tensor(arr)
    if not ZERO_COPY:
        return _build_frame_legacy(t, seed=seed, seq=seq,
                                   deadline_us=deadline_us, priority=priority,
                                   dev=resolve(device))
    frame = torch.empty((frame_rows(_meta_of(t)["nbytes"]), LANES),
                        dtype=torch.uint32, device=resolve(device))
    seal_into(frame, t, seed=seed, seq=seq, deadline_us=deadline_us,
              priority=priority, _inplace=False)
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
    _write_headers(frames, [_header(m, seed, seq, mac, 0, prio) for m, seq, mac, prio
                            in zip(metas, seqs, macs, priorities)])
    STATS.bump(frames_sealed=len(frames),
               bytes_copied=sum(m["nbytes"] for m in metas))
    return frames


def seal_batch_legacy(arrays: Sequence, *, seed: int, seqs: Sequence[int],
                      device="cuda") -> List[torch.Tensor]:
    """The legacy plane's batch seal (the reference's ``seal_batch``, which
    packs and assembles): each payload packed into a zeroed buffer when it
    needs padding (a view when it does not), the MACs of one
    :func:`mac_batch` pass, then each frame assembled into a fresh buffer
    behind its header. Bit-identical to :func:`seal_batch`'s frames; the
    transports and the gateway copy them into their slots or envelopes."""
    dev = resolve(device)
    packed = []
    for a in arrays:
        t = _as_tensor(a)
        meta = _meta_of(t)
        raw = _on_device(t, dev)
        rows = frame_rows(meta["nbytes"]) - 1
        if raw.numel() % (LANES * 4):
            payload = torch.zeros((rows, LANES), dtype=torch.uint32, device=dev)
            payload.reshape(-1).view(torch.uint8)[:raw.numel()].copy_(raw)
            STATS.bump(bytes_copied=raw.numel())
        else:
            payload = raw.view(torch.uint32).reshape(rows, LANES)
        packed.append((payload, meta))
    macs = mac_batch([p for p, _ in packed], seed)
    frames = []
    for payload, _ in packed:
        frame = torch.empty((payload.shape[0] + 1, LANES), dtype=torch.uint32,
                            device=dev)
        frame[1:].copy_(payload)
        frames.append(frame)
    _write_headers(frames, [_header(m, seed, q, mac) for (_, m), q, mac
                            in zip(packed, seqs, macs)])
    STATS.bump(frames_sealed=len(frames),
               bytes_copied=sum(p.numel() * 4 for p, _ in packed))
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


def verify_view(frame: torch.Tensor, *, seed: int, expect_seq=None,
                header: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The full receive-side guard: header prechecks, then the
    ``guard_copy`` kernel (MAC + protected copy of the payload in one
    pass), then the metadata checks. Returns the payload as a tensor of
    the frame's dtype and shape, a view of the guarded copy (so later
    writes to ``frame`` cannot reach it). ``header`` is the frame's header
    row as host words when the caller has already read it (a gateway reads
    it with its route words); otherwise it is read here. Raises
    :class:`FrameError`."""
    _check_shape(frame)
    header = frame[0].cpu().tolist() if header is None else list(header)
    _precheck(header, seed, expect_seq)
    copy, _, ok = ops.guard_copy(frame[1:], seed & MASK32,
                                 _expected_mac(header, seed))
    if not int(ok.cpu().tolist()[0]):
        raise FrameError("MAC mismatch — payload or header tampered/truncated")
    out = unpack_payload(copy, _check_fields(header, frame.shape[0]))
    STATS.bump(frames_verified=1, views_returned=1,
               bytes_copied=copy.numel() * 4)
    return out


# In the port both receive paths return the guarded copy.
parse_frame = verify_view


def header_rows(frames: Sequence[torch.Tensor]) -> List[list]:
    """The header rows of N frames on one device as host word lists, in
    one device-to-host copy."""
    if not frames:
        return []
    return (torch.stack([f[0].view(torch.int32) for f in frames])
            .cpu().numpy().view(np.uint32).tolist())


def verify_batch(frames: Sequence[torch.Tensor], *, seed: int,
                 seqs: Optional[Sequence[int]] = None,
                 start_seq: Optional[int] = None,
                 strict: bool = True,
                 headers: Optional[Sequence[Sequence[int]]] = None
                 ) -> List[Union[torch.Tensor, FrameError]]:
    """Receive-side guard for N frames with one ``mac_batch`` launch per
    row count. With ``strict=True`` the first bad frame raises (message
    prefixed with its batch index); with ``strict=False`` the list carries
    the ``FrameError`` in that frame's position. Payloads are views of the
    frames. The header rows are read back in one device-to-host copy, or
    taken from ``headers`` (host words, one list a frame) when the caller
    has read them already."""
    if seqs is None and start_seq is not None:
        seqs = [start_seq + i for i in range(len(frames))]
    out: List[Union[torch.Tensor, FrameError, None]] = [None] * len(frames)

    def refuse(i: int, e: FrameError) -> None:
        if strict:
            raise FrameError(f"frame {i}: {e}") from None
        out[i] = e

    shaped = []
    for i, f in enumerate(frames):
        try:
            _check_shape(f)
            shaped.append(i)
        except FrameError as e:
            refuse(i, e)
    rows = (header_rows([frames[i] for i in shaped]) if headers is None
            else [list(headers[i]) for i in shaped])
    headers: Dict[int, list] = {}
    for i, header in zip(shaped, rows):
        try:
            _precheck(header, seed, None if seqs is None else seqs[i])
            headers[i] = header
        except FrameError as e:
            refuse(i, e)
    candidates = list(headers)
    macs = mac_batch([frames[i][1:] for i in candidates], seed)
    STATS.bump(frames_verified=len(candidates))
    for i, mac in zip(candidates, macs):
        try:
            if mac != _expected_mac(headers[i], seed):
                raise FrameError(
                    "MAC mismatch — payload or header tampered/truncated")
            meta = _check_fields(headers[i], frames[i].shape[0])
            out[i] = unpack_payload(frames[i][1:], meta)
        except FrameError as e:
            refuse(i, e)
    return out


# ---------------------------------------------------------------------------
# arena of frame slots
# ---------------------------------------------------------------------------

DEFAULT_ARENA_ROWS = 1 << 17             # 64 MiB of 512-byte rows
ARENA_MIN_ROWS = 16                      # the smallest slot class


class FrameArena:
    """Recycling pool of ``(rows, 128)`` uint32 frame slots carved out of
    one backing tensor of ``rows`` rows on ``device`` (the reference's
    backed ``FrameArena``).

    Slots are size-classed (rows rounded up to the next power of two at or
    above :data:`ARENA_MIN_ROWS`) and carved from the backing with a bump
    cursor; released slots go to their class's free list and are handed
    out again, so the steady state carves nothing. Exhausting the backing
    raises :class:`FrameError` (the transports surface it as their typed
    capacity error). The backing is made at the first :meth:`acquire`, on
    the caller's current stream.

    The reference recycles a slot once numpy's reference counts show that
    no view of it is alive. Every slot of a torch backing shares one
    storage, so the port states its rule instead: **a slot is released
    only after the last kernel that reads it has been queued on the stream
    that every later writer of the slot uses** (a transport runs all its
    sessions' data-plane work on one stream, so a later seal into the
    reused slot runs after that read). Nothing handed to a caller aliases a
    slot: ``verify_view`` returns a view of ``guard_copy``'s protected copy,
    and the transports copy the payloads that ``verify_batch`` verified
    before they release the slots. Releasing a slot that is not out (twice,
    or a tensor the arena did not carve) raises. Thread-safe.

    ``backing`` carves the slots out of a caller's contiguous ``(rows,
    128)`` uint32 tensor instead (``rows`` and ``device`` are then its
    own): a process transport's slab, which a peer process maps too and
    reads through the slots' row offsets (:meth:`offset_rows`)."""

    def __init__(self, rows: int = DEFAULT_ARENA_ROWS, device="cuda", *,
                 backing: Optional[torch.Tensor] = None):
        if backing is not None:
            _check_buf(backing, 1)
            rows, device = backing.shape[0], backing.device
        self.rows, self.device = int(rows), resolve(device)
        self._backing: Optional[torch.Tensor] = backing
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._out: set = set()          # row offsets of the slots handed out
        self._brk = 0                   # rows carved so far
        self._lock = threading.Lock()

    def _class_rows(self, rows: int) -> int:
        c = ARENA_MIN_ROWS
        while c < rows:
            c <<= 1
        return c

    def acquire(self, rows: int) -> torch.Tensor:
        """A (class_rows, 128) uint32 slot with class_rows >= ``rows``,
        recycled from the free list when it has one, carved otherwise.
        Its contents are undefined (``seal_into`` writes the whole frame)."""
        c = self._class_rows(max(1, int(rows)))
        with self._lock:
            lst = self._free.get(c)
            if lst:
                buf = lst.pop()
                STATS.bump(arena_reused=1)
            else:
                if self._brk + c > self.rows:
                    raise FrameError(
                        f"arena exhausted: need {c} rows, {self.rows - self._brk} "
                        f"of {self.rows} left (slots out are not recycled "
                        f"until released)")
                if self._backing is None:
                    self._backing = torch.empty((self.rows, LANES),
                                                dtype=torch.uint32, device=self.device)
                buf = self._backing[self._brk:self._brk + c]
                self._brk += c
                STATS.bump(arena_allocated=1)
            self._out.add(self._offset(buf))
        return buf

    def _offset(self, buf: torch.Tensor) -> int:
        base = self._backing
        span = buf.data_ptr() - base.data_ptr() if base is not None else -1
        off, rem = divmod(span, LANES * 4)
        if (rem or off < 0 or buf.device != base.device or buf.ndim != 2
                or off + buf.shape[0] > base.shape[0]):
            raise FrameError("tensor is not a row-aligned slot of this arena")
        return off

    def offset_rows(self, buf: torch.Tensor) -> int:
        """Row offset of a carved slot inside the backing: where a peer
        that maps the backing finds the slot."""
        return self._offset(buf)

    def release(self, buf: Optional[torch.Tensor]) -> None:
        """Return a slot to its class's free list (under the rule above:
        the last kernel that reads it is already queued)."""
        if buf is None:
            return
        with self._lock:
            off = self._offset(buf)
            if off not in self._out:
                raise FrameError(f"slot at row {off} is not out (released "
                                 f"twice?)")
            self._out.discard(off)
            self._free.setdefault(buf.shape[0], []).append(buf)
        STATS.bump(arena_released=1)

    def free_slots(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._free.values())


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
