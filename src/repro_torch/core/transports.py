"""The paper's IPC transport zoo and the service step (the port of
``repro.core.transports``).

Microservices run as threads of one process (the paper's final design,
§VI) and exchange request/response messages through one of six
transports:

  pipe        two unidirectional OS pipes per session
  uds         one AF_UNIX stream socket pair per session
  shm         two raw shared regions (req/resp) with a FIXED capacity —
              fails for large payloads like the paper's baseline (incapable
              of >= 100k words)
  grpc_sim    the REST/gRPC stand-in: MessagePack bodies + 9-byte frame
              headers per 16 KiB DATA frame + a 64 KiB flow-control window
              acknowledged by WINDOW_UPDATE frames
  mpklink     shared regions + MPK emulation: one PKRU synchronization
              round trip per 64 KiB chunk (the paper's key-sync cost, its
              large-payload cliff), a domain-seeded MAC over every frame,
              CA-verified endpoints
  mpklink_opt ONE key sync per message (a batched epoch grant) — the cliff
              removed, the same MAC and capability checks

Every transport serves N concurrent sessions: ``transport.connect()``
returns a :class:`Session` with its own channel and a service thread, and
the mpklink variants give each its own CA enrollment, protection domain,
capability keys, MAC seed and sequence. Sessions also speak a ring of
message slots (``submit`` / ``flush`` / ``poll`` / ``call_batch``): on
shm, mpklink and mpklink_opt a real fixed-capacity ring (one key sync
covers every frame a flush publishes, one more every response of a drain
pass, and the drained batch's MACs run as one ``mac_batch`` launch per row
count); the stream transports keep the API through a lockstep fallback.
Signalling goes through :class:`Doorbell` (a bounded spin, then a park;
one ring wakes every waiter of a pass), with credit-based flow control on
full rings, and every wait is bounded: handler errors, capacity overflows,
crashes and timeouts reach the calling client as typed exceptions.

Where a frame lies. Each transport takes ``device=`` (``"cuda"`` by
default, through ``device.resolve``; the tests pass ``"cpu"``). On shm,
mpklink and mpklink_opt the request and response regions, the ring slots
and the transport's :class:`framing.FrameArena` are uint32 tensors on that
device: the client's staging write is the one host-to-device copy of a
payload, the MACs run where the frame lies (``framing.fast_mac``,
``verify_view``'s ``guard_copy``, ``verify_batch`` / ``seal_into_batch``'s
``mac_batch``), and the handler receives the request on the device. shm
keeps its regions where mpklink's are, so the two differ by the guard (MAC
and key syncs), not by the copy. pipe, uds and grpc_sim move host bytes
through the OS, as the paper's baselines do, and copy the payload to the
device once at the handler's boundary. A handler's response (a tensor on
any device, or an array) travels as its bytes (uint8).

Streams. On CUDA every data-plane kernel and copy of a transport runs on
one stream of its own (``transport.stream``): the client's methods and the
service threads enter it, so the host syncs of the data plane (header
reads, the guard's verdict) never wait behind work that other threads
queue on torch's default stream (an engine's tick). A CUDA payload handed
to a client method is ordered after the caller's stream; a payload handed
back is ordered before it (``wait_stream``) and recorded on it for the
allocator. A handler runs on the transport's stream; one that hands its
input to another stream orders that stream itself (``EngineService``
reads its request back to the host).

Arena slots. Under the rule of :class:`framing.FrameArena`, a slot is
released once the last kernel that reads it is queued on the transport's
stream, and nothing a client receives aliases a slot: ``poll`` returns
``guard_copy``'s protected copy (mpklink) or a copy of the slot (shm), and
``call_batch`` copies the payloads ``verify_batch`` verified. A handler's
argument is valid until the handler returns.

:func:`serve_frame` / :func:`serve_batch` are the one-frame and
batch-envelope service steps (``MPKLinkSession``'s verify → handle → seal
with the frame's lane-10 deadline and lane-12 priority published through
``core.gateway``).

``framing.ZERO_COPY = False`` restores the legacy copy plane on mpklink
and mpklink_opt (the reference's A/B yardstick): each frame is built by
``framing.build_frame``'s concatenations (a batch by
``framing.seal_batch_legacy``) and then copied into the region or ring
slot, and the MACs run the earlier two-launch kernels
(:func:`legacy_fast_mac`). Frames are bit-identical, so the two planes
share one session and its sequence. The process transports are in
:mod:`repro_torch.core.procwire`.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import select
import socket
import struct
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.checkpoint import msgpack_lite
from repro_torch.core import framing
from repro_torch.core import gateway
from repro_torch.core.ca import CertificateAuthority, enroll
from repro_torch.core.domains import (AccessViolation, KeyRegistry, READ, WRITE,
                                      RW, mac_seed)
from repro_torch.device import resolve
# the streaming MAC lives in framing (its seal path); it is re-exported
# here, where the reference keeps it
from repro_torch.core.framing import fast_mac, legacy_fast_mac  # noqa: F401

Handler = Callable[[torch.Tensor], object]


class TransportError(RuntimeError):
    pass


class CapacityError(TransportError):
    """Raised when a fixed-capacity transport cannot hold the payload."""


class ResponseTimeout(TransportError):
    """The client-side response wait expired (the service may still be
    alive, e.g. a dropped response). The session poisons itself."""


class DeadlineExpired(ResponseTimeout):
    """The request's propagated deadline (the lane-10 budget word) expired
    before the work could run or while it was queued. Retrying is
    pointless: the caller's budget is spent. Never poisons a session."""


class ServiceCrashed(TransportError):
    """The service handler/thread died while a request was in flight —
    distinct from :class:`ResponseTimeout` so retry layers fail over
    immediately instead of waiting out the deadline."""


class ServiceUnavailable(TransportError):
    """A circuit breaker is shedding load for this service: the request
    was rejected up front instead of being allowed to hang."""


class Overloaded(ServiceUnavailable):
    """Brownout admission shed, with a ``retry_after`` hint in seconds."""

    def __init__(self, msg: str = "service overloaded",
                 retry_after: float = 0.0):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class RateLimited(Overloaded):
    """Per-identity token-bucket shed: the caller exceeded its rate, so no
    failover heals it. Carries the bucket's ``retry_after`` hint."""

    def __init__(self, msg: str = "identity rate limited",
                 retry_after: float = 0.0):
        super().__init__(msg, retry_after=retry_after)


class HandlerCrash(BaseException):
    """Fault-injection signal: a handler failure that KILLS the service
    thread (a BaseException, so the per-request ``except Exception`` nets
    do not absorb it). The session turns it into a typed
    :class:`ServiceCrashed` for the waiting client."""


class DropResponse(BaseException):
    """Fault-injection signal: run the handler but never send the
    response; the client's bounded wait must expire while the service
    thread keeps serving."""


# exception types a service thread may propagate back to its client by name
_REMOTE_ERRORS: Dict[str, type] = {
    "CapacityError": CapacityError,
    "TransportError": TransportError,
    "ResponseTimeout": ResponseTimeout,
    "DeadlineExpired": DeadlineExpired,
    "ServiceCrashed": ServiceCrashed,
    "ServiceUnavailable": ServiceUnavailable,
    "Overloaded": Overloaded,
    "RateLimited": RateLimited,
    "AccessViolation": AccessViolation,
    "FrameError": framing.FrameError,
}


def _pack_error(exc: BaseException) -> bytes:
    info = {"type": type(exc).__name__, "msg": str(exc)}
    retry_after = getattr(exc, "retry_after", None)
    if retry_after is not None:
        info["retry_after"] = float(retry_after)
    return msgpack_lite.packb(info)


def _raise_remote(blob):
    info = msgpack_lite.unpackb(bytes(blob))
    cls = _REMOTE_ERRORS.get(info.get("type", ""), TransportError)
    if issubclass(cls, Overloaded):
        # the whole Overloaded family carries retry_after across the wire
        raise cls(info.get("msg", "remote service error"),
                  retry_after=info.get("retry_after", 0.0))
    raise cls(info.get("msg", "remote service error"))


# ---------------------------------------------------------------------------
# payload bytes
# ---------------------------------------------------------------------------

def _as_tensor(payload) -> torch.Tensor:
    if isinstance(payload, torch.Tensor):
        return payload.detach().contiguous()
    return torch.from_numpy(np.ascontiguousarray(payload))


def _raw(payload) -> torch.Tensor:
    """A payload (a tensor on any device, or an array) as its flat uint8
    bytes, where it lies."""
    return _as_tensor(payload).reshape(-1).view(torch.uint8)


def _seal_slots(bufs: Sequence[torch.Tensor], payloads, seed: int,
                seqs: Sequence[int]) -> List[int]:
    """Seal a ring batch into its arena slots → rows used per frame: in
    place with one ``mac_batch`` pass per row count, or in the legacy copy
    plane packed and assembled apart (``framing.seal_batch_legacy``) and
    then copied into the slots."""
    if framing.ZERO_COPY:
        return framing.seal_into_batch(bufs, payloads, seed=seed, seqs=seqs)
    frames = framing.seal_batch_legacy(payloads, seed=seed, seqs=seqs,
                                       device=bufs[0].device)
    for buf, frame in zip(bufs, frames):
        buf[:frame.shape[0]].copy_(frame)
    return [f.shape[0] for f in frames]


def _nbytes(payload) -> int:
    t = _as_tensor(payload)
    return t.numel() * t.element_size()


def _from_host(buf, device: torch.device) -> torch.Tensor:
    """Host bytes (from a socket or pipe) → a uint8 tensor on ``device``:
    the one copy of a stream transport's payload to the device."""
    if len(buf) == 0:
        return torch.empty(0, dtype=torch.uint8, device=device)
    with warnings.catch_warnings():     # a read-only buffer is copied below
        warnings.simplefilter("ignore")
        t = torch.frombuffer(buf, dtype=torch.uint8)
    if isinstance(buf, (bytes, memoryview)) and device.type == "cpu":
        t = t.clone()                   # never hand out read-only memory
    return t.to(device)


def _host(raw: torch.Tensor) -> np.ndarray:
    """uint8 bytes on any device as a host array (for the OS)."""
    with tracing.span("gateway.device_read"):
        return raw.cpu().numpy()


def _flat(obj):
    """The tensors of a call's arguments or result (one level of lists)."""
    items = obj if isinstance(obj, (list, tuple)) else (obj,)
    for x in items:
        if isinstance(x, (list, tuple)):
            yield from x
        else:
            yield x


def _stream_method(stream_of):
    """Decorate a method to run on the stream ``stream_of(self)`` (CUDA):
    the caller's stream is waited on first (payloads it wrote), and a CUDA
    tensor the method returns is ordered before the caller's stream and
    recorded on it (so the allocator does not hand its memory to the data
    plane while the caller still reads it). Re-entry from a method that is
    already on the stream runs directly."""
    def deco(fn):
        @functools.wraps(fn)
        def run(self, *args, **kw):
            s = stream_of(self)
            if s is None:
                return fn(self, *args, **kw)
            caller = torch.cuda.current_stream(s.device)
            if caller == s:
                return fn(self, *args, **kw)
            s.wait_stream(caller)
            with torch.cuda.stream(s):
                out = fn(self, *args, **kw)
            caller.wait_stream(s)
            for t in _flat(out):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(caller)
            return out
        return run
    return deco


# a client-side method of a region session runs on its transport's stream
_on_stream = _stream_method(lambda session: session.transport.stream)


# ---------------------------------------------------------------------------
# byte-stream helpers
# ---------------------------------------------------------------------------

_LEN = struct.Struct("<Q")
_ERR_BIT = 1 << 63                    # high bit of the length word = error


def _write_fd(fd: int, data: memoryview):
    while data:
        n = os.write(fd, data[: 1 << 20])
        data = data[n:]


def _write_fd_deadline(fd: int, data: memoryview, timeout: Optional[float]):
    """Write all of ``data``; with ``timeout`` the fd must be non-blocking
    and the whole write is select(2)-bounded — a full pipe against a dead
    reader raises :class:`ResponseTimeout` instead of hanging forever."""
    if timeout is None:
        return _write_fd(fd, data)
    deadline = time.monotonic() + timeout
    while data:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise ResponseTimeout(f"pipe write timed out after {timeout}s")
        _, ready, _ = select.select([], [fd], [], remaining)
        if not ready:
            continue
        try:
            n = os.write(fd, data[: 1 << 20])
        except BlockingIOError:
            continue
        data = data[n:]


def _read_fd(fd: int, n: int, timeout: Optional[float] = None) -> bytearray:
    """Read exactly n bytes; with ``timeout`` the whole read is bounded by a
    select(2) deadline and raises :class:`ResponseTimeout` on expiry."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    deadline = None if timeout is None else time.monotonic() + timeout
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ResponseTimeout(
                    f"pipe read timed out after {timeout}s")
            ready, _, _ = select.select([fd], [], [], remaining)
            if not ready:
                continue
        chunk = os.read(fd, min(n - got, 1 << 20))
        if not chunk:
            raise TransportError("pipe closed")
        view[got:got + len(chunk)] = chunk
        got += len(chunk)
    return buf


# ---------------------------------------------------------------------------
# doorbell: hybrid spin/park wakeup (one ring covers a whole drain pass)
# ---------------------------------------------------------------------------

# predicate probes (each yields the GIL) before parking: a long spin under
# load burns timeslices that a park would have spent asleep
DOORBELL_SPIN = 2


class Doorbell:
    """Hybrid spin-then-park wakeup for the ring data plane.

    A waiter probes its predicate :data:`DOORBELL_SPIN` times (yielding the
    GIL between probes), then parks on a condition until :meth:`ring` or
    the timeout. One ``ring()`` is a broadcast: a service draining a batch
    notifies its pollers ONCE per pass. Doorbells of one session share
    ``lock`` (an RLock), so a parked re-check reads the state under the
    lock that guards it. Rings count in ``framing.STATS.wakeups``, parks in
    ``framing.STATS.doorbell_parks``."""

    __slots__ = ("cond", "spin")

    def __init__(self, lock: Optional[threading.RLock] = None,
                 spin: Optional[int] = None):
        self.cond = threading.Condition(lock)
        self.spin = DOORBELL_SPIN if spin is None else spin

    def ring(self):
        """Wake every waiter (acquires the shared lock briefly)."""
        with self.cond:
            self.cond.notify_all()
        framing.STATS.bump(wakeups=1)

    def ring_owned(self):
        """:meth:`ring` for callers already holding the shared lock."""
        self.cond.notify_all()
        framing.STATS.bump(wakeups=1)

    def wait(self, pred: Callable[[], bool], timeout: float) -> bool:
        """True once ``pred()`` holds; False when ``timeout`` expires first.
        The spin reads shared state without the lock (the ring's
        transitions are monotonic and the park re-checks under the lock)."""
        if pred():
            return True
        for _ in range(self.spin):
            time.sleep(0)               # yield — don't starve the peer
            if pred():
                return True
        framing.STATS.bump(doorbell_parks=1)
        with self.cond:
            return self.cond.wait_for(pred, timeout)


# ---------------------------------------------------------------------------
# ring of message slots (the pipelined data plane)
# ---------------------------------------------------------------------------

# slot lifecycle: FREE → STAGED (submit) → PUBLISHED (flush) → DONE (service
# wrote response/error; poll frees) — or DROPPED (injected wire drop: the
# slot never completes and the client's bounded poll() expires)
_FREE, _STAGED, _PUBLISHED, _DONE, _DROPPED = range(5)


class _RingSlot:
    """One message slot: request/response storage + status + typed error.
    shm slots hold raw bytes in arena slots (``req`` / ``resp``); mpklink
    slots carry sealed frames (``frame`` / ``resp_frame``, views of the
    arena slots in ``req`` / ``resp``)."""

    __slots__ = ("state", "ticket", "req", "req_len", "resp", "resp_len",
                 "frame", "resp_frame", "seq", "error")

    def __init__(self):
        self.state = _FREE
        self.ticket = -1
        self.req = None
        self.req_len = 0
        self.resp = None
        self.resp_len = 0
        self.frame = None
        self.resp_frame = None
        self.seq = 0
        self.error: Optional[BaseException] = None


class _Ring:
    """Fixed-capacity ring of :class:`_RingSlot`. Ticket → slot is
    ``ticket % capacity``; ``head`` is the service's drain cursor. Every
    state transition happens under ``cv`` (the emulation's guarded
    head/tail control word), which shares the session's lock; wakeups go
    through the session's doorbells."""

    def __init__(self, capacity: int, lock: Optional[threading.RLock] = None):
        self.capacity = capacity
        self.slots = [_RingSlot() for _ in range(capacity)]
        self.head = 0                   # service drain cursor (ticket)
        self.cv = threading.Condition(lock)


# ---------------------------------------------------------------------------
# session / transport base
# ---------------------------------------------------------------------------

class Session:
    """One client's private channel to the service: its own wire and a
    dedicated service thread. ``request()`` is synchronous per session;
    open one session per client thread."""

    def __init__(self, transport: "Transport", name: str):
        self.transport = transport
        self.name = name
        self.device = transport.device
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        self._crashed = False
        self._poisoned = False
        # one lock guards all ring/signalling state; the two doorbells
        # (service-facing and client-facing) park on conditions over it
        self._slk = threading.RLock()
        self._bell_svc = Doorbell(self._slk)    # client → service wakeups
        self._bell_cli = Doorbell(self._slk)    # service → client wakeups
        self._credit_waiters = 0                # submit()s blocked on credit
        self._tickets = 0
        self._ring: Optional[_Ring] = None
        self._outstanding: set = set()      # issued, not yet redeemed
        self._lazy_pending: Dict[int, object] = {}
        self._lazy_results: Dict[int, tuple] = {}

    @property
    def handler(self) -> Handler:
        # resolved per request, so a swapped transport.handler takes effect
        # on live sessions too
        return self.transport.handler

    def _handle(self, req: torch.Tensor) -> torch.Tensor:
        """Run the handler; its response as uint8 bytes, where the handler
        left them (the copy into a region or slot crosses devices)."""
        return _raw(self.handler(req))

    # -- lifecycle --------------------------------------------------------
    def ensure_started(self):
        if self._thread is None and not self._closed:
            self._thread = threading.Thread(
                target=self._serve, daemon=True,
                name=f"{self.transport.name}:{self.name}")
            self._thread.start()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._wake()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._teardown()
        self.transport._forget(self)

    # -- per-transport hooks ----------------------------------------------
    def _wake(self):
        pass

    def _teardown(self):
        pass

    def _serve(self):
        """Thread body: the transport's serve loop on its stream. If it dies
        with a request possibly in flight, mark the session crashed and push
        a typed :class:`ServiceCrashed` to the waiting client at once."""
        try:
            with self.transport.on_stream():
                self._serve_loop()
        except BaseException as e:          # noqa: B036 — crash containment
            if self._stop.is_set():
                return
            self._crashed = True
            try:
                self._notify_crash(ServiceCrashed(
                    f"service thread for session {self.name!r} crashed: "
                    f"{type(e).__name__}: {e}"))
            # mpklint: disable=MPK105 reason=crash notify is best-effort; session already dead
            except Exception:
                pass

    def _serve_loop(self):
        raise NotImplementedError

    def _notify_crash(self, exc: ServiceCrashed):
        """Deliver ``exc`` to a client blocked on this session's response."""

    def _check_usable(self):
        if self._crashed:
            raise ServiceCrashed(
                f"session {self.name!r}: service thread is dead — "
                f"open a new session")
        self._check_pollable()

    def _check_pollable(self):
        """:meth:`_check_usable` without the crash check: a crashed service
        may still hold honestly completed ring slots, which poll() redeems."""
        if self._poisoned:
            raise TransportError(
                "session poisoned by an earlier timeout (a stale response "
                "may be in flight) — open a new session")
        if self._closed:
            raise TransportError(f"session {self.name!r} is closed")

    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        """Synchronous single exchange: send ``payload`` (a tensor or an
        array), block for the response bytes (or its typed error). One in
        flight per session. ``timeout`` tightens the response deadline for
        THIS exchange; expiry poisons the session."""
        raise NotImplementedError

    def request_into(self, nbytes: int, fill,
                     timeout: Optional[float] = None) -> torch.Tensor:
        """Producer exchange: ``fill(dst)`` writes the ``nbytes`` message
        into the transport's staging storage (a uint8 view of the request
        region on mpklink), then the exchange proceeds like
        :meth:`request`. This fallback stages one buffer on the
        transport's device."""
        buf = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        fill(buf)
        return self.request(buf, timeout=timeout)

    # -- pipelined API (ring transports override; base = lockstep fallback) --
    def submit(self, payload, timeout: Optional[float] = None) -> int:
        """Stage one request; returns a ticket redeemable with :meth:`poll`.
        The lockstep fallback buffers the payload and runs the exchange in
        poll(); ring transports write it into the next free slot, and a
        full ring blocks up to ``transport.credit_wait`` (clamped to
        ``timeout``) for a credit before a typed error."""
        self._check_usable()
        t = self._tickets
        self._tickets += 1
        self._lazy_pending[t] = payload
        return t

    def flush(self):
        """Publish everything staged by :meth:`submit` (no-op for the
        lockstep fallback; ONE control-word update — one key sync on
        mpklink_opt — however many messages were staged)."""

    def poll(self, ticket: int, timeout: Optional[float] = None) -> torch.Tensor:
        """Redeem ``ticket``: its response, or its typed error. Blocks up to
        ``timeout`` (transport default when None); the lockstep fallback
        runs the buffered exchanges under one per-poll deadline."""
        if ticket not in self._lazy_results and ticket not in self._lazy_pending:
            raise TransportError(f"unknown or already-redeemed ticket {ticket}")
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in sorted(self._lazy_pending):        # FIFO up to the ticket
            if t > ticket:
                break
            payload = self._lazy_pending.pop(t)
            try:
                remaining = None if deadline is None \
                    else max(1e-3, deadline - time.monotonic())
                self._lazy_results[t] = (True, self.request(
                    payload, timeout=remaining))
            except Exception as e:
                self._lazy_results[t] = (False, e)
        ok, val = self._lazy_results.pop(ticket)
        if not ok:
            raise val
        return val

    def call_batch(self, payloads, return_exceptions: bool = False):
        """Submit every payload, flush once, poll every ticket → responses
        in order. Per-message failures stay typed: with
        ``return_exceptions`` the exception sits in that message's place;
        otherwise the first error is raised after the batch has drained."""
        tickets = [self.submit(p) for p in payloads]
        self.flush()
        out, first = [], None
        for t in tickets:
            try:
                out.append(self.poll(t))
            except Exception as e:          # noqa: PERF203 — per-ticket fate
                if first is None:
                    first = e
                out.append(e)
        if first is not None and not return_exceptions:
            raise first
        return out

    # -- shared ring redeem --------------------------------------------------
    def _ring_obj(self) -> _Ring:
        if self._ring is None:
            self._ring = _Ring(self.transport.ring_slots, self._slk)
        return self._ring

    def _slot_take(self, slot: _RingSlot):
        """Extract a completed slot's response (under the ring lock, just
        before the slot is freed). Ring sessions override."""
        raise NotImplementedError

    def _ring_redeem(self, ticket: int, timeout: Optional[float]):
        """Wait (bounded) for ``ticket``'s slot to reach DONE, mark it
        redeemed and free it → ``(error, extracted)``. A never-issued or
        already-redeemed ticket raises at once; a crash surfaces as
        ServiceCrashed; an expiry poisons the session. The wait is the
        client doorbell: ONE service-side ring per drain pass wakes every
        poller of that pass."""
        ring = self._ring
        if ring is None or ticket >= self._tickets:
            raise TransportError(f"unknown ticket {ticket}")
        timeout = self.transport.timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        slot = ring.slots[ticket % ring.capacity]

        def settled():                  # lock-free probe; re-checked locked
            return (slot.ticket == ticket and slot.state == _DONE) \
                or self._crashed or self._closed

        with ring.cv:
            if ticket not in self._outstanding:
                raise TransportError(f"ticket {ticket} already redeemed")
        while True:
            self._bell_cli.wait(
                settled, max(0.0, deadline - time.monotonic()))
            with ring.cv:
                if slot.ticket == ticket and slot.state == _DONE:
                    self._outstanding.discard(ticket)
                    err, slot.error = slot.error, None
                    extracted = None if err is not None \
                        else self._slot_take(slot)
                    slot.state = _FREE
                    if self._credit_waiters:    # grant the freed credit
                        self._bell_cli.ring_owned()
                    return err, extracted
                if self._crashed:
                    raise ServiceCrashed(
                        f"session {self.name!r}: service thread died with "
                        f"ticket {ticket} in flight")
                if self._closed:
                    raise TransportError(f"session {self.name!r} is closed")
                if time.monotonic() >= deadline:
                    self._poisoned = True
                    raise ResponseTimeout(
                        f"ring response timed out after {timeout}s")

    def _await_credit(self, ring: _Ring, deadline: Optional[float] = None):
        """Credit-based flow control: block (bounded by
        ``transport.credit_wait``, clamped by the caller's absolute
        ``deadline``) until the next slot is FREE; a concurrent poll()
        freeing a slot grants the credit. What is staged is published
        first. Expiry of the credit window raises :class:`CapacityError`,
        of the caller's budget :class:`ResponseTimeout` (without poisoning:
        nothing was submitted)."""
        slot = ring.slots[self._tickets % ring.capacity]
        if slot.state == _FREE:
            return
        # the credit clock starts BEFORE the publish, which must not extend it
        credit_deadline = time.monotonic() + self.transport.credit_wait
        eff_deadline = credit_deadline if deadline is None \
            else min(credit_deadline, deadline)
        self.flush()

        def free():
            return slot.state == _FREE or self._crashed or self._closed

        with ring.cv:
            self._credit_waiters += 1
        try:
            while True:
                self._bell_cli.wait(
                    free, max(0.0, eff_deadline - time.monotonic()))
                with ring.cv:
                    if slot.state == _FREE:
                        return
                    if self._crashed:
                        raise ServiceCrashed(
                            f"session {self.name!r}: service thread died "
                            f"while waiting for a ring credit")
                    if self._closed:
                        raise TransportError(
                            f"session {self.name!r} is closed")
                    if time.monotonic() >= eff_deadline:
                        if eff_deadline < credit_deadline:
                            raise ResponseTimeout(
                                f"call budget exhausted while waiting for "
                                f"a ring credit (ring full, "
                                f"{ring.capacity} messages in flight)")
                        raise CapacityError(
                            f"ring full ({ring.capacity} messages in "
                            f"flight) — poll() before submitting more")
        finally:
            with ring.cv:
                self._credit_waiters -= 1

    def _acquire_slots(self, rows: Sequence[int]) -> List[torch.Tensor]:
        """Arena slots of at least ``rows[i]`` rows each, or (releasing what
        it took) a typed :class:`CapacityError` when the arena is full."""
        arena, got = self.transport.arena, []
        try:
            for r in rows:
                got.append(arena.acquire(r))
        except framing.FrameError as e:
            for b in got:
                arena.release(b)
            raise CapacityError(str(e)) from None
        return got


class Transport:
    """Base: a service handler plus N client sessions (threads of one
    process). ``device`` is where the region transports keep their
    regions and slots; ``stream`` (CUDA only) is the one stream of the
    transport's data plane; ``arena`` is the transport-wide
    :class:`framing.FrameArena` of ring slots (made at first use)."""

    name = "?"
    DEFAULT_RING_SLOTS = 8              # in-flight messages per session ring
    DEFAULT_CREDIT_WAIT = 1.0           # submit() backpressure bound (s)

    def __init__(self, handler: Handler, timeout: float = 120.0,
                 ring_slots: Optional[int] = None,
                 credit_wait: Optional[float] = None, *, device="cuda"):
        self.handler = handler
        self.timeout = timeout          # client-side response deadline
        self.ring_slots = ring_slots or self.DEFAULT_RING_SLOTS
        self.credit_wait = self.DEFAULT_CREDIT_WAIT \
            if credit_wait is None else credit_wait
        self.device = resolve(device)
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.arena = framing.FrameArena(device=self.device)
        self._sessions: List[Session] = []
        self._slock = threading.Lock()
        self._default: Optional[Session] = None
        self._counter = itertools.count()

    def on_stream(self):
        """A context that makes the transport's stream current (CUDA)."""
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    # -- session management -----------------------------------------------
    def _make_session(self, name: str) -> Session:
        raise NotImplementedError

    def connect(self, name: Optional[str] = None) -> Session:
        """Open a new client session (own channel + service thread)."""
        with self.on_stream():
            s = self._make_session(
                name or f"{self.name}-client-{next(self._counter)}")
        with self._slock:
            self._sessions.append(s)
        s.ensure_started()
        return s

    def _forget(self, session: Session):
        with self._slock:
            if session in self._sessions:
                self._sessions.remove(session)

    # -- single-client API ---------------------------------------------------
    def start(self):
        with self._slock:
            sessions = list(self._sessions)
        for s in sessions:
            s.ensure_started()
        return self

    def request(self, payload) -> torch.Tensor:
        d = self._default
        if d is None or d._closed or d._crashed or d._poisoned:
            if d is not None and not d._closed:
                d.close()       # a poisoned/crashed session is done for
            self._default = self.connect("svc-client")
            self._on_new_default()
        self._default.ensure_started()
        return self._default.request(payload)

    def _on_new_default(self):
        """Hook: the default session was replaced (first use, or recovery
        after a poisoning timeout)."""

    def close(self):
        with self._slock:
            sessions = list(self._sessions)
        for s in sessions:
            s.close()


# ---------------------------------------------------------------------------
# 1. OS pipes (two unidirectional per session)
# ---------------------------------------------------------------------------

class PipeSession(Session):
    def __init__(self, transport, name):
        super().__init__(transport, name)
        self._c2s = os.pipe()
        self._s2c = os.pipe()
        # the client's write end is non-blocking so that request() sends
        # can be deadline-bounded (a dead service stops draining the pipe)
        os.set_blocking(self._c2s[1], False)

    def _send_error(self, exc: BaseException):
        blob = _pack_error(exc)
        _write_fd(self._s2c[1], memoryview(_LEN.pack(len(blob) | _ERR_BIT)))
        _write_fd(self._s2c[1], memoryview(blob))

    def _serve_loop(self):
        while not self._stop.is_set():
            try:
                n = _LEN.unpack(bytes(_read_fd(self._c2s[0], 8)))[0]
            except (TransportError, OSError):
                return
            if n == 0:
                return
            req = _from_host(_read_fd(self._c2s[0], n), self.device)
            try:
                raw = _host(self._handle(req))
            except DropResponse:                   # injected wire drop
                continue
            except Exception as e:                 # propagate, don't die
                self._send_error(e)
                continue
            _write_fd(self._s2c[1], memoryview(_LEN.pack(raw.nbytes)))
            _write_fd(self._s2c[1], memoryview(raw))

    def _notify_crash(self, exc: ServiceCrashed):
        try:
            self._send_error(exc)
        except OSError:
            pass

    def _wake(self):
        try:
            os.write(self._c2s[1], _LEN.pack(0))
        except OSError:
            pass

    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_usable()
        timeout = self.transport.timeout if timeout is None else timeout
        raw = _host(_raw(payload))
        try:
            _write_fd_deadline(self._c2s[1],
                               memoryview(_LEN.pack(raw.nbytes)), timeout)
            _write_fd_deadline(self._c2s[1], memoryview(raw), timeout)
            n = _LEN.unpack(bytes(_read_fd(self._s2c[0], 8, timeout)))[0]
            if n & _ERR_BIT:
                _raise_remote(_read_fd(self._s2c[0], n & ~_ERR_BIT, timeout))
            return _from_host(_read_fd(self._s2c[0], n, timeout),
                              torch.device("cpu"))
        except ResponseTimeout:
            # a late response may still arrive; never let it be read as the
            # answer to a NEW request
            self._poisoned = True
            if self._crashed:
                raise ServiceCrashed(
                    f"session {self.name!r}: service thread died mid-request")
            raise

    def _teardown(self):
        for fd in (*self._c2s, *self._s2c):
            try:
                os.close(fd)
            except OSError:
                pass


class PipeTransport(Transport):
    name = "pipe"

    def _make_session(self, name):
        return PipeSession(self, name)


# ---------------------------------------------------------------------------
# 2. Unix domain sockets (one bidirectional pair per session)
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            # EOF mid-message is peer DEATH, not a protocol error
            raise ServiceCrashed(
                f"peer closed the socket mid-read ({got}/{n} bytes)")
        got += r
    return buf


class UDSSession(Session):
    def __init__(self, transport, name):
        super().__init__(transport, name)
        self._client, self._server = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_STREAM)
        self._client.settimeout(transport.timeout)

    def _send_error(self, exc: BaseException):
        blob = _pack_error(exc)
        self._server.sendall(_LEN.pack(len(blob) | _ERR_BIT))
        self._server.sendall(blob)

    def _serve_loop(self):
        while not self._stop.is_set():
            try:
                n = _LEN.unpack(bytes(_recv_exact(self._server, 8)))[0]
            except (TransportError, OSError):
                return
            if n == 0:
                return
            req = _from_host(_recv_exact(self._server, n), self.device)
            try:
                resp = _host(self._handle(req))
            except DropResponse:                   # injected wire drop
                continue
            except Exception as e:
                self._send_error(e)
                continue
            self._server.sendall(_LEN.pack(resp.nbytes))
            self._server.sendall(resp)

    def _notify_crash(self, exc: ServiceCrashed):
        try:
            self._send_error(exc)
        except OSError:
            pass

    def _wake(self):
        try:
            self._client.sendall(_LEN.pack(0))
        except OSError:
            pass

    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_usable()
        eff = self.transport.timeout if timeout is None else timeout
        self._client.settimeout(eff)
        raw = _host(_raw(payload))
        try:
            # sends are inside the timeout net too: a stalled send desyncs
            # the stream mid-message and must poison the session
            self._client.sendall(_LEN.pack(raw.nbytes))
            self._client.sendall(raw)
            n = _LEN.unpack(bytes(_recv_exact(self._client, 8)))[0]
            if n & _ERR_BIT:
                _raise_remote(_recv_exact(self._client, n & ~_ERR_BIT))
            return _from_host(_recv_exact(self._client, n), torch.device("cpu"))
        except socket.timeout:
            self._poisoned = True
            if self._crashed:
                raise ServiceCrashed(
                    f"session {self.name!r}: service thread died mid-request")
            raise ResponseTimeout(
                f"uds response timed out after {eff}s") from None

    def _teardown(self):
        self._client.close()
        self._server.close()


class UDSTransport(Transport):
    name = "uds"

    def _make_session(self, name):
        return UDSSession(self, name)


# ---------------------------------------------------------------------------
# 3. raw shared memory, fixed capacity (the paper's failing baseline)
# ---------------------------------------------------------------------------

def _region(nbytes: int, device: torch.device) -> torch.Tensor:
    """A zeroed uint32 region of at least ``nbytes`` bytes, as uint8."""
    return torch.zeros(-(-nbytes // 4), dtype=torch.uint32,
                       device=device).view(torch.uint8)


class ShmSession(Session):
    """One client's pair of raw regions on the transport's device + a ring
    of message slots. Lockstep ``request()`` uses the one-slot region pair
    (the paper's baseline); ``submit`` / ``flush`` / ``poll`` use a ring
    whose slots are arena slots holding raw bytes."""

    def __init__(self, transport, name):
        super().__init__(transport, name)
        self.capacity = transport.capacity
        self._req = _region(self.capacity, self.device)
        self._resp = _region(self.capacity, self.device)
        self._req_len = 0
        self._resp_len = 0
        self._req_pending = False       # lockstep request staged (vs ring wake)
        self._resp_flag = False         # lockstep response/error delivered
        self._error: Optional[BaseException] = None

    def _svc_pending(self) -> bool:
        """Service doorbell predicate: a lockstep request is staged, a
        published ring slot awaits the drain cursor, or we're stopping."""
        if self._stop.is_set() or self._req_pending:
            return True
        ring = self._ring
        if ring is None:
            return False
        slot = ring.slots[ring.head % ring.capacity]
        return slot.state == _PUBLISHED and slot.ticket == ring.head

    def _serve_loop(self):
        while not self._stop.is_set():
            if not self._bell_svc.wait(self._svc_pending, timeout=0.5):
                continue
            if self._stop.is_set():
                return
            if self._req_pending:
                self._req_pending = False
                self._serve_lockstep()
            self._drain_ring()

    def _too_big(self, nbytes: int, what: str) -> CapacityError:
        return CapacityError(f"shm region ({self.capacity}B) cannot hold "
                             f"{nbytes}B {what}")

    def _serve_lockstep(self):
        req = self._req[: self._req_len]
        try:
            resp = self._handle(req)
            if resp.numel() > self.capacity:
                raise self._too_big(resp.numel(), "response")
            self._error = None
            self._resp[: resp.numel()].copy_(resp)
            self._resp_len = resp.numel()
        except DropResponse:                   # injected wire drop: the
            return                             # client wait must expire
        except Exception as e:                 # incl. CapacityError
            self._error = e
            self._resp_len = 0
        self._resp_flag = True
        self._bell_cli.ring()

    # -- ring (pipelined) path: slots are arena slots of raw bytes ---------
    @staticmethod
    def _bytes_rows(nbytes: int) -> int:
        return -(-nbytes // (framing.LANES * 4))

    @_on_stream
    def submit(self, payload, timeout: Optional[float] = None) -> int:
        self._check_usable()
        raw = _raw(payload)
        if raw.numel() > self.capacity:
            raise self._too_big(raw.numel(), "payload")
        ring = self._ring_obj()
        # backpressure BEFORE paying for a slot + payload copy
        self._await_credit(ring, None if timeout is None
                           else time.monotonic() + timeout)
        buf, = self._acquire_slots([self._bytes_rows(raw.numel())])
        buf.reshape(-1).view(torch.uint8)[: raw.numel()].copy_(raw)
        with ring.cv:
            t = self._tickets
            slot = ring.slots[t % ring.capacity]
            if slot.state != _FREE:     # re-check: sessions are serial per
                self.transport.arena.release(buf)   # client, but stay safe
                raise CapacityError(
                    f"ring full ({ring.capacity} messages in flight) — "
                    f"poll() before submitting more")
            self._tickets += 1
            self._outstanding.add(t)
            slot.ticket = t
            slot.req = buf
            slot.req_len = raw.numel()
            slot.error = None
            slot.state = _STAGED
        return t

    def flush(self):
        ring = self._ring
        if ring is None:
            return
        published = False
        with ring.cv:
            for s in ring.slots:
                if s.state == _STAGED:
                    s.state = _PUBLISHED
                    published = True
        if published:
            self._bell_svc.ring()       # one ring covers the whole flush

    def _drain_ring(self):
        """Consume published slots in ticket order; completed slots are
        announced with ONE client-doorbell ring per drain pass."""
        ring = self._ring
        if ring is None:
            return
        arena = self.transport.arena
        completed = 0
        while True:
            with ring.cv:
                slot = ring.slots[ring.head % ring.capacity]
                if slot.state != _PUBLISHED or slot.ticket != ring.head:
                    break
                req = slot.req.reshape(-1).view(torch.uint8)[: slot.req_len]
            error = resp = rbuf = None
            try:                        # handler outside the ring lock
                resp = self._handle(req)
                if resp.numel() > self.capacity:
                    raise self._too_big(resp.numel(), "response")
                rbuf, = self._acquire_slots([self._bytes_rows(resp.numel())])
                rbuf.reshape(-1).view(torch.uint8)[: resp.numel()].copy_(resp)
            except DropResponse:        # injected wire drop: this slot never
                with ring.cv:           # completes; its poll() must expire
                    arena.release(slot.req)
                    slot.req = None
                    slot.state = _DROPPED
                    ring.head += 1
                continue
            except Exception as e:
                error = e
            with ring.cv:
                arena.release(slot.req)     # its readers are queued
                slot.req = None
                if error is None:
                    slot.resp = rbuf
                    slot.resp_len = resp.numel()
                else:
                    slot.error = error
                    slot.resp_len = 0
                slot.state = _DONE
                ring.head += 1
                completed += 1
        if completed:
            self._bell_cli.ring()

    def _slot_take(self, slot: _RingSlot):
        """A copy of the response bytes; the slot is released once the copy
        (its last reader) is queued."""
        buf, slot.resp = slot.resp, None
        out = buf.reshape(-1).view(torch.uint8)[: slot.resp_len].clone()
        self.transport.arena.release(buf)
        return out

    @_on_stream
    def poll(self, ticket: int, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_pollable()
        self.flush()                    # poll implies publish
        err, resp = self._ring_redeem(ticket, timeout)
        if err is not None:
            raise err
        return resp

    def _notify_crash(self, exc: ServiceCrashed):
        # wake the blocked waiter at once with the typed crash
        self._error = exc
        self._resp_len = 0
        self._resp_flag = True
        self._bell_cli.ring()

    def _wake(self):
        # a waiter woken by close() must get an error, never the previous
        # request's bytes masquerading as its response
        self._error = TransportError("session closed while request in flight")
        self._resp_flag = True
        self._bell_svc.ring()
        self._bell_cli.ring()

    @_on_stream
    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_usable()
        eff = self.transport.timeout if timeout is None else timeout
        raw = _raw(payload)
        if raw.numel() > self.capacity:
            raise self._too_big(raw.numel(), "payload")
        self._req[: raw.numel()].copy_(raw)
        self._req_len = raw.numel()
        self._resp_flag = False
        self._req_pending = True
        self._bell_svc.ring()
        if not self._bell_cli.wait(lambda: self._resp_flag, eff):
            # the service may still deliver later; never let that stale
            # response be mistaken for the answer to a NEW request
            self._poisoned = True
            if self._crashed:
                raise ServiceCrashed(
                    f"session {self.name!r}: service thread died mid-request")
            raise ResponseTimeout(
                f"shm response timed out after {eff}s")
        self._resp_flag = False
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._resp[: self._resp_len].clone()


class ShmTransport(Transport):
    """Two regions (req/resp) per session + length words + ready flags.
    The capacity is fixed at construction: payloads beyond it raise
    CapacityError in either direction, reproducing the paper's observation
    that baseline shm "is incapable of handling requests involving 100,000
    words or more"."""

    name = "shm"
    DEFAULT_CAPACITY = 512 * 1024      # ≈70k words of ~7 chars — fails at 100k

    def __init__(self, handler: Handler, capacity: int = DEFAULT_CAPACITY,
                 timeout: float = 120.0, ring_slots: Optional[int] = None,
                 credit_wait: Optional[float] = None, **kw):
        super().__init__(handler, timeout=timeout, ring_slots=ring_slots,
                         credit_wait=credit_wait, **kw)
        self.capacity = capacity

    def _make_session(self, name):
        return ShmSession(self, name)


# ---------------------------------------------------------------------------
# 4. gRPC simulation (serialization + HTTP/2 framing + flow control)
# ---------------------------------------------------------------------------

class GrpcSimSession(Session):
    def __init__(self, transport, name):
        super().__init__(transport, name)
        self.FRAME = transport.FRAME
        self.WINDOW = transport.WINDOW
        self._HDR = transport._HDR
        self._client, self._server = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_STREAM)
        for s in (self._client, self._server):
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 20)
        self._client.settimeout(transport.timeout)

    def _send_msg(self, sock: socket.socket, obj):
        body = msgpack_lite.packb(obj)
        sent = 0
        credit = self.WINDOW
        while sent < len(body):
            if credit <= 0:                      # wait for WINDOW_UPDATE
                hdr = _recv_exact(sock, self._HDR.size)
                ln, typ, _ = self._HDR.unpack(bytes(hdr))
                if typ != 8:
                    raise TransportError("expected WINDOW_UPDATE")
                credit += ln
            n = min(self.FRAME, len(body) - sent, credit)
            sock.sendall(self._HDR.pack(n, 0, 1))
            sock.sendall(body[sent:sent + n])
            sent += n
            credit -= n
        sock.sendall(self._HDR.pack(0, 1, 1))    # END_STREAM

    def _recv_msg(self, sock: socket.socket):
        chunks = []
        consumed = 0
        while True:
            hdr = _recv_exact(sock, self._HDR.size)
            ln, typ, _ = self._HDR.unpack(bytes(hdr))
            if typ == 1:
                break
            if typ == 8:
                continue              # a WINDOW_UPDATE for our own sends
            chunks.append(bytes(_recv_exact(sock, ln)))
            consumed += ln
            if consumed >= self.WINDOW // 2:     # grant more window
                sock.sendall(self._HDR.pack(consumed, 8, 1))
                consumed = 0
        return msgpack_lite.unpackb(b"".join(chunks))

    def _serve_loop(self):
        while not self._stop.is_set():
            try:
                msg = self._recv_msg(self._server)
            except (TransportError, OSError):
                return
            if msg.get("op") == "stop":
                return
            req = _from_host(msg["data"], self.device)
            try:
                resp = _host(self._handle(req))
            except DropResponse:                   # injected wire drop
                continue
            except Exception as e:
                self._send_msg(self._server,
                               {"status": 1, "error": _pack_error(e)})
                continue
            self._send_msg(self._server, {"status": 0, "data": resp.tobytes()})

    def _notify_crash(self, exc: ServiceCrashed):
        try:
            self._send_msg(self._server, {"status": 1, "error": _pack_error(exc)})
        except OSError:
            pass

    def _wake(self):
        try:
            self._send_msg(self._client, {"op": "stop"})
        except OSError:
            pass

    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_usable()
        eff = self.transport.timeout if timeout is None else timeout
        self._client.settimeout(eff)
        raw = _host(_raw(payload))
        try:
            self._send_msg(self._client, {"op": "count", "data": raw.tobytes()})
            resp = self._recv_msg(self._client)
        except socket.timeout:
            self._poisoned = True
            if self._crashed:
                raise ServiceCrashed(
                    f"session {self.name!r}: service thread died mid-request")
            raise ResponseTimeout(
                f"grpc_sim response timed out after {eff}s") from None
        if resp.get("status"):
            _raise_remote(resp["error"])
        return _from_host(resp["data"], torch.device("cpu"))

    def _teardown(self):
        self._client.close()
        self._server.close()


class GrpcSimTransport(Transport):
    """MessagePack body + 9-byte frame header per 16 KiB DATA frame + a
    64 KiB flow-control window with WINDOW_UPDATE acks — the protocol
    overhead the paper attributes to network-style IPC between co-located
    services."""

    name = "grpc_sim"
    FRAME = 16 * 1024
    WINDOW = 64 * 1024
    _HDR = struct.Struct("<IBI")       # length, type, stream_id

    def _make_session(self, name):
        return GrpcSimSession(self, name)


# ---------------------------------------------------------------------------
# 5. MPKLink (paper-faithful) and 6. MPKLink-opt
# ---------------------------------------------------------------------------

class MPKLinkSession(Session):
    """One CA-enrolled client endpoint: its own protection domain shared
    with the server, capability keys, session-derived MAC seed, framing
    sequence, and regions on the transport's device."""

    def __init__(self, transport: "MPKLinkTransport", name: str):
        super().__init__(transport, name)
        self.chunk = transport.chunk
        self.registry = transport.registry
        # --- control plane: CA handshake (per client) ----------------------
        self._kp, _ = enroll(transport.ca, name)
        self.domain, self.key_client, self.key_server = \
            transport.ca.grant_channel(name, transport.server_name, RW)
        sess = transport.ca.session_seed(self._kp.private, transport.server_name)
        self.seed = mac_seed(self.domain,
                             self.registry.epoch(self.domain)) ^ sess
        # --- data plane: regions on the device + PKRU "register file" ------
        self._region_req = self._new_region(0)
        self._region_resp = self._new_region(0)
        self._pkru = np.zeros(2, np.uint64)        # [pkru_word, epoch]
        self._chunk_pending = False                # client staged a chunk sync
        self._chunk_acked = False                  # service loaded the PKRU word
        self._resp_flag = False                    # lockstep response delivered
        self._final = False                        # last chunk of a request?
        self._error: Optional[BaseException] = None
        self._req_rows = 0
        self._resp_rows = 0
        self._seq = 0
        self.sync_count = 0                        # per-session key syncs
        # the client thread and the service thread both bump sync_count
        self._sync_slk = threading.Lock()

    def _new_region(self, rows: int) -> torch.Tensor:
        return torch.empty((rows, framing.LANES), dtype=torch.uint32,
                           device=self.device)

    def _bump_sync(self):
        """One PKRU key-sync round trip: session- and transport-level
        accounting (both counters have concurrent writers)."""
        with self._sync_slk:
            self.sync_count += 1
        self.transport._bump_sync()

    # -- one PKRU synchronization round trip (writer side) -------------------
    def _sync_key(self, key, rights):
        self.registry.check(key, rights)           # staging-time capability check
        self._pkru[0] = self.registry.pkru_word((key,))
        self._pkru[1] = self.registry.epoch(self.domain)
        self._bump_sync()
        self._chunk_acked = False
        self._chunk_pending = True
        self._bell_svc.ring()
        # bounded ack wait: a service thread that dies mid-exchange acks at
        # most once (via _notify_crash), so surface the typed crash instead
        # of stranding a multi-sync send forever
        while True:
            self._bell_cli.wait(
                lambda: self._chunk_acked or self._crashed or self._closed
                or self._stop.is_set(), timeout=0.5)
            if self._chunk_acked:
                break
            if self._crashed:
                raise ServiceCrashed(
                    f"session {self.name!r}: service thread died during a "
                    f"key-sync round trip")
            if self._closed or self._stop.is_set():
                raise TransportError(
                    f"session {self.name!r} closed during a key sync")
        self._chunk_acked = False

    def _svc_pending(self) -> bool:
        return self._stop.is_set() or self._chunk_pending

    def _serve_loop(self):
        while not self._stop.is_set():
            if not self._bell_svc.wait(self._svc_pending, timeout=0.5):
                continue
            if not self._chunk_pending:            # woken to stop
                if self._stop.is_set():
                    return
                continue
            self._chunk_pending = False
            if self._stop.is_set():
                self._chunk_acked = True
                self._bell_cli.ring()
                return
            final = self._final                    # read before acking
            self._chunk_acked = True               # reader loads PKRU word
            self._bell_cli.ring()
            self._drain_ring()                     # published ring slots
            if final:
                self._serve_lockstep()

    def _respond(self, rows: int, error: Optional[BaseException] = None):
        self._error = error
        self._resp_rows = rows
        self._resp_flag = True
        self._bell_cli.ring()

    def _serve_lockstep(self):
        """The whole frame is visible: verify (``guard_copy``), handle, seal
        the response into the response region."""
        self.registry.check(self.key_server, READ)
        try:
            req = framing.verify_view(self._region_req[: self._req_rows],
                                      seed=self.seed, expect_seq=self._seq)
        except framing.FrameError:
            return self._respond(0)                # guard rejection
        self.registry.check(self.key_server, WRITE)
        try:
            resp = self._handle(req)
        except DropResponse:                       # injected wire drop: the
            return                                 # client wait must expire
        except Exception as e:
            return self._respond(0, e)
        rows = framing.frame_rows(resp.numel())
        if self._region_resp.shape[0] < rows:
            self._region_resp = self._new_region(rows)
        if framing.ZERO_COPY:
            framing.seal_into(self._region_resp, resp, seed=self.seed,
                              seq=self._seq)
        else:                                      # the legacy copy plane
            self._region_resp[:rows].copy_(framing.build_frame(
                resp, seed=self.seed, seq=self._seq,
                device=self._region_resp.device))
        self._bump_sync()                          # response-side key sync
        self._respond(rows)

    def _notify_crash(self, exc: ServiceCrashed):
        # one client-doorbell ring wakes the chunk-ack, lockstep and ring
        # waiters with the typed crash
        self._error = exc
        self._resp_rows = 0
        self._chunk_acked = True
        self._resp_flag = True
        self._bell_cli.ring()

    def _wake(self):
        self._final = False
        self._chunk_acked = True
        self._resp_flag = True
        self._bell_svc.ring()
        self._bell_cli.ring()

    def _teardown(self):
        # give the pkey back, so long-lived transports can cycle through
        # many more sessions than the key-table size
        self.registry.free_domain(self.domain)

    def _grow_req(self, rows: int):
        if self._region_req.shape[0] < rows:
            self._region_req = self._new_region(rows)

    @_on_stream
    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_usable()
        rows = framing.frame_rows(_nbytes(payload))
        self._grow_req(rows)
        if not framing.ZERO_COPY:       # built apart, copied in chunk by chunk
            frame = framing.build_frame(payload, seed=self.seed, seq=self._seq,
                                        device=self._region_req.device)
            return self._exchange(rows, legacy_frame=frame, timeout=timeout)
        # the seal lands in the region: one write of the payload, the MAC
        # over it in place, the header last
        framing.seal_into(self._region_req, payload, seed=self.seed,
                          seq=self._seq)
        return self._exchange(rows, timeout=timeout)

    @_on_stream
    def request_into(self, nbytes: int, fill,
                     timeout: Optional[float] = None) -> torch.Tensor:
        """``fill(dst)`` writes the message straight into the request
        region's payload bytes (a uint8 tensor on the device), which are
        then pad-zeroed, MAC'd in place and headed
        (``framing.seal_prefilled``)."""
        self._check_usable()
        if not framing.ZERO_COPY:       # the legacy plane fills a fresh buffer
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              device=self._region_req.device)
            fill(buf)
            return self.request(buf, timeout=timeout)
        rows = framing.frame_rows(nbytes)
        self._grow_req(rows)
        fill(self._region_req[1:rows].reshape(-1).view(torch.uint8)[:nbytes])
        framing.seal_prefilled(self._region_req, nbytes, seed=self.seed,
                               seq=self._seq)
        return self._exchange(rows, timeout=timeout)

    def _exchange(self, rows: int, legacy_frame: Optional[torch.Tensor] = None,
                  timeout: Optional[float] = None) -> torch.Tensor:
        """The chunk-sync publish loop + bounded response wait + response
        guard, shared by request() / request_into(). A ``legacy_frame``
        (the legacy copy plane's) is copied into the region a chunk at a
        time, before that chunk's key sync."""
        eff = self.transport.timeout if timeout is None else timeout
        chunk_rows = max(1, self.chunk // (framing.LANES * 4))
        self._resp_flag = False
        for s in range(0, rows, chunk_rows):
            if legacy_frame is not None:
                e = min(rows, s + chunk_rows)
                self._region_req[s:e].copy_(legacy_frame[s:e])
            self._req_rows = rows
            self._final = min(rows, s + chunk_rows) >= rows
            self._sync_key(self.key_client, WRITE)
        if not self._bell_cli.wait(lambda: self._resp_flag, eff):
            self._poisoned = True       # a late response must never be
            if self._crashed:           # read back as the next one's answer
                raise ServiceCrashed(
                    f"session {self.name!r}: service thread died mid-request")
            raise ResponseTimeout(
                f"mpklink response timed out after {eff}s")
        self._resp_flag = False
        if self._resp_rows == 0:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise TransportError("server rejected frame (guard failure)")
        self.registry.check(self.key_client, READ)
        out = framing.verify_view(self._region_resp[: self._resp_rows],
                                  seed=self.seed, expect_seq=self._seq)
        self._seq += 1
        return out

    # -- ring (pipelined) path --------------------------------------------
    def _stage_frame(self, frame: torch.Tensor, buf=None) -> int:
        """Write one sealed frame into the next free slot (STAGED; flush()
        publishes). The slot remembers the frame's sequence number so the
        drain verifies exactly what the client committed to. ``buf`` is
        the arena slot backing ``frame``, released once the service has
        consumed the request."""
        self._check_usable()
        ring = self._ring_obj()
        with ring.cv:
            t = self._tickets
            slot = ring.slots[t % ring.capacity]
            if slot.state != _FREE:
                if buf is not None:
                    self.transport.arena.release(buf)
                raise CapacityError(
                    f"ring full ({ring.capacity} messages in flight) — "
                    f"poll() before submitting more")
            self._tickets += 1
            self._outstanding.add(t)
            slot.ticket = t
            slot.frame = frame
            slot.req = buf
            slot.seq = self._seq
            slot.error = None
            slot.resp_frame = None
            slot.resp = None
            slot.state = _STAGED
        self._seq += 1
        return t

    @_on_stream
    def submit(self, payload, timeout: Optional[float] = None) -> int:
        self._check_usable()
        # backpressure BEFORE paying for a slot + seal + MAC
        self._await_credit(self._ring_obj(), None if timeout is None
                           else time.monotonic() + timeout)
        if not framing.ZERO_COPY:       # built apart, copied into the slot
            frame = framing.build_frame(payload, seed=self.seed, seq=self._seq,
                                        device=self._region_req.device)
            buf, = self._acquire_slots([frame.shape[0]])
            buf[:frame.shape[0]].copy_(frame)
            return self._stage_frame(buf[:frame.shape[0]], buf=buf)
        buf, = self._acquire_slots([framing.frame_rows(_nbytes(payload))])
        rows = framing.seal_into(buf, payload, seed=self.seed, seq=self._seq)
        return self._stage_frame(buf[:rows], buf=buf)

    def flush(self):
        """Publish all staged slots with ONE batched key-sync round trip
        (chunk-scaled for paper-faithful mpklink: ceil(bytes / chunk) syncs
        over the published frames; mpklink_opt's huge chunk makes that
        exactly one) — k frames cross for O(1) synchronization."""
        ring = self._ring
        if ring is None or self._crashed:   # a dead thread can't ack syncs
            return
        staged_bytes = 0
        with ring.cv:
            for s in ring.slots:
                if s.state == _STAGED:
                    s.state = _PUBLISHED
                    staged_bytes += s.frame.numel() * 4
        if not staged_bytes:
            return
        for _ in range(max(1, -(-staged_bytes // self.chunk))):
            self._final = False         # never mistaken for a lockstep frame
            self._sync_key(self.key_client, WRITE)

    def _finish(self, ring: _Ring, slot: _RingSlot, *, error=None,
                state: int = _DONE):
        """Release a drained request slot and settle it (ring lock held)."""
        self.transport.arena.release(slot.req)
        slot.req = None
        slot.error = error
        slot.state = state
        if state == _DONE:
            self._bell_cli.ring_owned()         # fail fast per slot

    def _drain_ring(self):
        """Service side: consume published slots in ticket order. The
        drained batch is verified with ``mac_batch`` launches
        (``framing.verify_batch``), handlers run per message (typed
        per-slot errors), and the responses are sealed into arena slots
        with ``mac_batch`` launches (``seal_into_batch``) under ONE
        response-side key sync."""
        ring = self._ring
        if ring is None:
            return
        while True:
            batch: List[_RingSlot] = []
            with ring.cv:
                while True:
                    slot = ring.slots[ring.head % ring.capacity]
                    if slot.state != _PUBLISHED or slot.ticket != ring.head:
                        break
                    batch.append(slot)
                    ring.head += 1
            if not batch:
                return
            self.registry.check(self.key_server, READ)
            parsed = framing.verify_batch(
                [s.frame for s in batch], seed=self.seed,
                seqs=[s.seq for s in batch], strict=False)
            self.registry.check(self.key_server, WRITE)
            ok_slots, responses = [], []
            for slot, res in zip(batch, parsed):
                if isinstance(res, framing.FrameError):
                    with ring.cv:
                        self._finish(ring, slot, error=res)
                    continue
                try:                    # handler errors stay per-slot typed
                    responses.append(self._handle(res))
                    ok_slots.append(slot)
                except DropResponse:    # injected wire drop: never completes
                    with ring.cv:
                        self._finish(ring, slot, state=_DROPPED)
                except Exception as e:
                    with ring.cv:
                        self._finish(ring, slot, error=e)
            if not ok_slots:
                continue
            try:
                rbufs = self._acquire_slots(
                    [framing.frame_rows(r.numel()) for r in responses])
            except CapacityError as e:
                with ring.cv:
                    for slot in ok_slots:
                        self._finish(ring, slot, error=e)
                continue
            rows_list = _seal_slots(rbufs, responses, self.seed,
                                    [s.seq for s in ok_slots])
            self._bump_sync()           # ONE response-side key sync a batch
            with ring.cv:
                for slot, rb, rows in zip(ok_slots, rbufs, rows_list):
                    # the request slot's readers (MACs, handler, the seal's
                    # copy of a response that aliased it) are queued
                    self.transport.arena.release(slot.req)
                    slot.req = None
                    slot.resp_frame = rb[:rows]
                    slot.resp = rb
                    slot.state = _DONE
                # ONE doorbell ring covers every poller of the pass
                self._bell_cli.ring_owned()

    def _slot_take(self, slot: _RingSlot):
        rframe, slot.resp_frame = slot.resp_frame, None
        rbuf, slot.resp = slot.resp, None
        return rframe, slot.seq, rbuf

    def _collect(self, ticket: int, timeout: Optional[float] = None):
        """Wait for ``ticket``'s slot to complete → its raw response
        (frame, seq, arena slot), MAC not yet verified. Frees the ring
        slot."""
        err, extracted = self._ring_redeem(ticket, timeout)
        if err is not None:
            raise err
        return extracted

    @_on_stream
    def poll(self, ticket: int, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_pollable()
        self.flush()                    # poll implies publish
        rframe, seq, rbuf = self._collect(ticket, timeout)
        try:
            self.registry.check(self.key_client, READ)
            # mpklint: disable=MPK102 reason=verify_view returns guard_copy's owned copy (core/framing.py verify_view); no arena view escapes
            return framing.verify_view(rframe, seed=self.seed, expect_seq=seq)
        finally:                        # guard_copy (its reader) is queued
            self.transport.arena.release(rbuf)

    @_on_stream
    def call_batch(self, payloads, return_exceptions: bool = False):
        """Ring-pipelined batch: the frames are sealed into arena slots with
        ``mac_batch`` launches, staged, published with one flush (one key
        sync on mpklink_opt), and the responses are verified with
        ``mac_batch`` launches and copied out of their slots. Batches
        larger than the ring run in ring-sized windows."""
        self._check_usable()
        cap = self._ring_obj().capacity
        out: List = []
        first: Optional[BaseException] = None
        for start in range(0, len(payloads), cap):
            window = [_as_tensor(p) for p in payloads[start:start + cap]]
            bufs = self._acquire_slots(
                [framing.frame_rows(_nbytes(p)) for p in window])
            rows_list = _seal_slots(bufs, window, self.seed,
                                    [self._seq + i for i in range(len(window))])
            tickets = [self._stage_frame(b[:r], buf=b)
                       for b, r in zip(bufs, rows_list)]
            self.flush()
            collected: List = []
            for t in tickets:
                try:
                    collected.append(self._collect(t))
                except Exception as e:  # noqa: PERF203 — per-ticket fate
                    collected.append(e)
            ok = [(i, fs) for i, fs in enumerate(collected)
                  if not isinstance(fs, BaseException)]
            if ok:
                self.registry.check(self.key_client, READ)
                verified = framing.verify_batch(
                    [f for _, (f, _, _) in ok], seed=self.seed,
                    seqs=[q for _, (_, q, _) in ok], strict=False)
                for (i, (_, _, rbuf)), v in zip(ok, verified):
                    collected[i] = v if isinstance(v, framing.FrameError) \
                        else v.clone()
                    self.transport.arena.release(rbuf)
            for item in collected:
                if isinstance(item, BaseException) and first is None:
                    first = item
                out.append(item)
        if first is not None and not return_exceptions:
            raise first
        return out


class MPKLinkTransport(Transport):
    """Shared regions + MPK emulation (paper-faithful).

    Establishment (once per session): the client enrolls with the CA (key
    pair + proof of possession), the CA verifies certificates and grants a
    channel domain shared with the server; the data-plane MAC seed is the
    domain tag ⊕ epoch mix ⊕ DH session key. Each session holds its own
    domain, keys and seed, so a frame from one session fails the guard on
    any other.

    Per message the frame is sealed into the session's request region and
    published in CHUNK-sized pieces, each with one PKRU synchronization
    round trip (the writer updates the PKRU word, the reader acknowledges):
    ``syncs_per_message = ceil(frame_bytes / chunk)`` plus one on the
    response side, the paper's large-payload cliff. The receiver re-derives
    the MAC and refuses tampered or foreign frames.

    ``registry`` / ``ca`` may be shared so that channels and service
    domains live in ONE key table; ``max_keys`` lifts the 16-domain x86
    limit for many-client runs (a documented deviation)."""

    name = "mpklink"
    CHUNK = 64 * 1024

    def __init__(self, handler: Handler, chunk: Optional[int] = None, *,
                 registry: Optional[KeyRegistry] = None,
                 ca: Optional[CertificateAuthority] = None,
                 max_keys: Optional[int] = None,
                 server_name: str = "svc-server",
                 timeout: float = 120.0,
                 ring_slots: Optional[int] = None,
                 credit_wait: Optional[float] = None, **kw):
        super().__init__(handler, timeout=timeout, ring_slots=ring_slots,
                         credit_wait=credit_wait, **kw)
        self.chunk = chunk or self.CHUNK
        self.server_name = server_name
        standalone = registry is None and ca is None
        self.registry = registry or KeyRegistry(max_keys=max_keys or 16, seed=7)
        self.ca = ca or CertificateAuthority(self.registry)
        if server_name not in self.ca._services:
            self._kp_server, _ = enroll(self.ca, server_name)
        self.sync_count = 0                        # aggregate across sessions
        self._sync_lock = threading.Lock()
        if standalone:
            # eager default session: its domain / seed / keys are there to
            # inspect before start(). With a shared registry or CA, sessions
            # come only from connect().
            with self.on_stream():
                d = self._make_session("svc-client")
            with self._slock:
                self._sessions.append(d)
            self._default = d
            self._on_new_default()

    def _on_new_default(self):
        d = self._default
        self._kp_client = d._kp
        self.domain = d.domain
        self.key_client = d.key_client
        self.key_server = d.key_server
        self.seed = d.seed

    def _bump_sync(self, n: int = 1):
        with self._sync_lock:
            self.sync_count += n
        framing.STATS.bump(key_syncs=n)

    @property
    def _seq(self) -> int:
        return self._default._seq if self._default is not None else 0

    def _make_session(self, name):
        return MPKLinkSession(self, name)


class MPKLinkOptTransport(MPKLinkTransport):
    """MPKLink with ONE key synchronization per message (a batched epoch
    grant over the whole frame) instead of one per chunk. The MAC and
    capability checks are unchanged: the cliff comes out of the sync
    schedule, not out of the protection."""

    name = "mpklink_opt"

    def __init__(self, handler: Handler, **kw):
        kw.setdefault("chunk", 1 << 62)
        super().__init__(handler, **kw)


# ---------------------------------------------------------------------------
# the service step on bare frames
# ---------------------------------------------------------------------------

def _lanes(frame: torch.Tensor) -> tuple:
    """(absolute deadline or None, priority) of a verified frame."""
    with tracing.span("gateway.device_read"):
        words = frame[0, :framing.PRIORITY_LANE + 1].cpu().tolist()
    return (gateway.deadline_of(words[framing.DEADLINE_LANE]),
            words[framing.PRIORITY_LANE])


def serve_frame(frame: torch.Tensor, handler: Callable, *, seed: int,
                seq: int) -> torch.Tensor:
    """One request frame → one response frame on the same device.

    Raises :class:`framing.FrameError` when the guard refuses the frame,
    :class:`DeadlineExpired` when its propagated deadline has passed before
    execution, and whatever typed error the handler raises."""
    req = framing.verify_view(frame, seed=seed, expect_seq=seq)
    deadline, priority = _lanes(frame)
    if deadline is not None and time.monotonic() >= deadline:
        raise DeadlineExpired("propagated deadline expired before execution")
    prev = gateway.push_context(deadline, priority)
    try:
        resp = handler(req)
    finally:
        gateway.pop_context(prev)
    return framing.build_frame(resp, seed=seed, seq=seq, device=frame.device)


def serve_batch(frames: Union[torch.Tensor, Sequence[torch.Tensor]],
                batch_handler: Callable, *, seed: int,
                seqs: Sequence[int]) -> List[Union[torch.Tensor, BaseException]]:
    """A batch envelope (a row-concatenation of frames, or a list of them)
    → one response frame or typed error per item, in order.

    Frames the guard refuses keep their ``FrameError``; expired items get
    :class:`DeadlineExpired`; the rest go to ``batch_handler`` in one call
    under the cohort's tightest deadline and most urgent priority, and
    their responses are sealed with one ``seal_batch``. A handler failure
    becomes every executed item's error."""
    if isinstance(frames, torch.Tensor):
        frames = framing.split_frames(frames)
    results: List[Union[torch.Tensor, BaseException, None]] = list(
        framing.verify_batch(frames, seed=seed, seqs=seqs, strict=False))
    now = time.monotonic()
    good, deadlines, priorities = [], [], []
    for i, p in enumerate(results):
        if isinstance(p, framing.FrameError):
            continue
        deadline, priority = _lanes(frames[i])
        if deadline is not None and now >= deadline:
            results[i] = DeadlineExpired(
                "propagated deadline expired before execution")
            continue
        good.append(i)
        if deadline is not None:
            deadlines.append(deadline)
        priorities.append(priority)
    if not good:
        return results
    prev = gateway.push_context(min(deadlines) if deadlines else None,
                                min(priorities, key=gateway.priority_rank))
    try:
        outs = batch_handler([results[i] for i in good])
        if len(outs) != len(good):
            raise TransportError(f"batch handler returned {len(outs)} "
                                 f"responses for {len(good)} requests")
    except Exception as e:          # every executed item carries the error
        for i in good:
            results[i] = e
        return results
    finally:
        gateway.pop_context(prev)
    sealable = [(i, o) for i, o in zip(good, outs)
                if not isinstance(o, BaseException)]
    for i, o in zip(good, outs):
        if isinstance(o, BaseException):
            results[i] = o
    sealed = framing.seal_batch([o for _, o in sealable], seed=seed,
                                seqs=[seqs[i] for i, _ in sealable],
                                device=frames[0].device)
    for (i, _), f in zip(sealable, sealed):
        results[i] = f
    return results
