"""MPKLink service gateway: named services multiplexed over one transport
(the port of ``repro.core.gateway``).

The transports in :mod:`repro_torch.core.transports` move bytes between ONE
client and ONE handler. The gateway is the routing/multiplexing layer on
top: one co-located process exposes N **named services**, each behind its
own **protection domain**, and M concurrent clients call them through one
transport. Its wire format is the reference's, bit for bit (the normative
spec lives in docs/protocol.md):

  request   [GW_MAGIC, service_id, client_id, token]  (4×u32 route words)
            + MPKLink frame MAC-seeded with the (client, service) channel
              seed and per-channel sequence
  response  [GW_MAGIC, status, service_id, err_len]
            + status 0: response frame under the same channel seed/seq
            + status 1: msgpack {"type", "msg"} error blob (typed re-raise
              client-side)

  batch     [GW_BATCH_MAGIC, service_id, client_id, n_items] + n frames;
            response [GW_MAGIC, 2, service_id, n] + per item
            [GW_MAGIC, status, byte_len, 0] + body (a frame, or an error
            blob padded to 4 bytes)
  scatter   [GW_SCAT_MAGIC, client_id, n_items, 0] + per item
            [GW_MAGIC, service_id, token, 0] + one frame sealed under THAT
            service's channel; response [GW_MAGIC, 3, client_id, n] + the
            batch response's item layout

With ``workers=N`` the gateway runs N shard threads; each service is
pinned to shard ``sid % N``, so one scatter envelope's items fan out
across shards while per-channel order, sequence discipline, idempotency
dedup and breaker semantics stay the single-call ones. Every service gets
its own :class:`ProtectionDomain` in the gateway's shared
:class:`KeyRegistry`; a client enrolls with the gateway CA and opens a
channel per service (CA-checked, allow-listed); the channel MAC seed is
service-domain tag ⊕ epoch mix ⊕ DH session key, so a frame sealed for
service A fails service B's guard, and revocation bumps the domain epoch.

Where the bytes lie. Envelopes are uint8 tensors on the transport's device
(``device=``, ``"cuda"`` by default). Every MAC runs where the frame lies,
on the guard kernels (``framing.verify_view``'s ``guard_copy``,
``fast_mac``'s ``mac_update`` when sealing one frame, ``mac_batch`` for
the frames of a batch, scatter or cohort); there is no host MAC and so no
``mac_impl`` parameter. The host reads only what routing needs: the route
words and the inner frame's header row in one copy for a single envelope,
and item headers through a read-ahead window (:class:`_HostBytes`) when a
batch or scatter envelope is walked. An item that follows an error blob
(padded to 4 bytes only) is copied to a fresh, aligned tensor before a
guard kernel reads it. Work the gateway does on threads of its own (the
shards, the coalescer's carrier, clients) runs on the transport's stream,
so it is ordered with the transport's own data plane (``transports``,
"Streams"). Results handed to clients, and responses kept in the dedup
window, are tensors that own their memory.

Process transports. A ``*_proc`` name resolves to ``procwire``'s process
transports (the default of :meth:`ServiceGateway.register_replica` and
:meth:`ServiceFleet.add`): each replica's handler runs in a child process
started by a forkserver. A gateway whose own transport is a process
transport is itself sent to its service process: it pickles without its
transport, threads, shards and coalescer (``__getstate__``), and the child
rebuilds its shards on its own stream and serves ``_dispatch``.
:class:`FleetSupervisor` probes a fleet's replicas and actuates
``runtime.elastic``'s planners.
"""
from __future__ import annotations

import contextlib
import itertools
import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core import framing
from repro_torch.core.ca import CertificateAuthority, enroll
from repro_torch.core.domains import (AccessViolation, DomainKey, KeyRegistry,
                                      ProtectionDomain, RW, READ, WRITE, mac_seed)
from repro_torch.device import resolve

Handler = Callable[[torch.Tensor], object]

GW_MAGIC = 0x4D504B47               # "MPKG"
GW_BATCH_MAGIC = 0x4D504B42         # "MPKB" — batch request envelope
GW_SCAT_MAGIC = 0x4D504B53          # "MPKS" — scatter (multi-service) envelope
_ROUTE_BYTES = 16                   # 4 × u32 route words
_HEAD_BYTES = _ROUTE_BYTES + framing.LANES * 4  # route words + a frame header
_READ_AHEAD = 64 * 1024             # host window of an envelope walk (bytes)
_OK, _ERR, _BOK, _SOK = 0, 1, 2, 3  # _BOK/_SOK: batch/scatter response follows
_MAX_SCATTER = 1024                 # items per scatter envelope

# replica fleet states (normative: docs/protocol.md §8) — the drain state
# machine is strictly forward: ACTIVE → DRAINING → QUIESCED, with DEAD
# reachable from ACTIVE/DRAINING on a detected crash.
REPLICA_ACTIVE = 0
REPLICA_DRAINING = 1
REPLICA_QUIESCED = 2
REPLICA_DEAD = 3
_REPLICA_STATE_NAMES = {REPLICA_ACTIVE: "active",
                        REPLICA_DRAINING: "draining",
                        REPLICA_QUIESCED: "quiesced",
                        REPLICA_DEAD: "dead"}
FLEET_CHOICES = 2                   # power-of-two-choices candidate count
HEDGE_RESERVOIR = 128               # dispatch-latency samples behind the
                                    # adaptive hedge-delay quantile
REKEY_LIMIT = 8                     # consecutive stale-epoch re-keys one
                                    # call survives: each corresponds to a
                                    # distinct membership/revocation epoch
                                    # bump racing the call; a banned client
                                    # fails inside reopen() itself, so this
                                    # cannot spin


# ---------------------------------------------------------------------------
# the request context (normative: docs/protocol.md §9, §10)
#
# A call's remaining budget rides the MAC-covered lane-10 deadline word and
# its QoS class the lane-12 word. The execution cores convert the budget to
# an absolute time.monotonic() deadline at arrival, shed expired work
# before execution, and publish the deadline, the caller's CA identity and
# its priority class thread-locally around every handler call — so the
# engine and fleet dispatch compute against them.
# ---------------------------------------------------------------------------

_BUDGET = threading.local()


def current_deadline() -> Optional[float]:
    """Absolute ``time.monotonic()`` deadline of the request the calling
    thread is executing (None = no deadline)."""
    return getattr(_BUDGET, "deadline", None)


def remaining_budget() -> Optional[float]:
    """Seconds left on the current request's propagated deadline (None =
    no deadline; may be <= 0 when already expired)."""
    d = current_deadline()
    return None if d is None else d - time.monotonic()


def _push_deadline(deadline: Optional[float]) -> Optional[float]:
    prev = getattr(_BUDGET, "deadline", None)
    _BUDGET.deadline = deadline
    return prev


def _pop_deadline(prev: Optional[float]) -> None:
    _BUDGET.deadline = prev


def current_identity() -> Optional[str]:
    """CA identity (client name) of the request the calling thread is
    executing under the gateway (None = not in a request, or an
    identity-less hop). Fleet dispatch keys its per-tenant fair queue on
    it (docs/protocol.md §10)."""
    return getattr(_BUDGET, "identity", None)


def current_priority() -> int:
    """Priority class of the request the calling thread is executing (the
    verified frame's lane-12 word; cohort paths publish the most urgent
    class present). ``PRIO_NORMAL`` outside a request."""
    return getattr(_BUDGET, "priority", framing.PRIO_NORMAL)


def _push_qos(identity: Optional[str], priority: int) -> tuple:
    prev = (getattr(_BUDGET, "identity", None),
            getattr(_BUDGET, "priority", framing.PRIO_NORMAL))
    _BUDGET.identity = identity
    _BUDGET.priority = priority
    return prev


def _pop_qos(prev: tuple) -> None:
    _BUDGET.identity, _BUDGET.priority = prev


def push_context(deadline: Optional[float], priority: int) -> tuple:
    """Publish a request's deadline and priority (the service step
    ``transports.serve_frame`` / ``serve_batch``, which has no CA
    identity); returns what to restore."""
    return _push_deadline(deadline), _push_qos(None, priority)


def pop_context(prev: tuple) -> None:
    _pop_deadline(prev[0])
    _pop_qos(prev[1])


# priority classes ordered by urgency: HIGH expedites, BULK yields. Rank
# order (lower = more urgent) is the ONE comparison every QoS consumer
# (coalescer window, serving admission) shares.
_PRIO_RANK = {framing.PRIO_HIGH: 0, framing.PRIO_NORMAL: 1,
              framing.PRIO_BULK: 2}


def priority_rank(priority: int) -> int:
    """Scheduling rank of a priority class — lower is more urgent. Unknown
    classes rank as PRIO_NORMAL."""
    return _PRIO_RANK.get(int(priority), 1)


def deadline_of(deadline_us: int) -> Optional[float]:
    """Absolute deadline from a verified frame's lane-10 word (the
    receiver restarts the remaining budget at arrival, the convention that
    holds across processes since monotonic clocks don't compare)."""
    return None if deadline_us == 0 else time.monotonic() + deadline_us / 1e6


def _frame_deadline(header: Sequence[int]) -> Optional[float]:
    """Absolute deadline from a VERIFIED frame's header words (lane 10)."""
    return deadline_of(int(header[framing.DEADLINE_LANE]))


def _frame_priority(header: Sequence[int]) -> int:
    """Priority class from a VERIFIED frame's header words (lane 12,
    MAC-covered — a tampered class cannot reach scheduling decisions)."""
    return int(header[framing.PRIORITY_LANE])


# The transports publish the context above through this module, so they are
# imported after it.
from repro_torch.core.transports import (DeadlineExpired, HandlerCrash,  # noqa: E402
                                         MPKLinkTransport, Overloaded, RateLimited,
                                         ResponseTimeout, ServiceCrashed,
                                         ServiceUnavailable, Transport,
                                         TransportError, _pack_error,
                                         _raise_remote, _stream_method)


def _transport_class(transport: Union[str, type]) -> type:
    if not isinstance(transport, str):
        return transport
    from repro_torch.core import ALL_TRANSPORTS
    return ALL_TRANSPORTS[transport]


class RetryBudget:
    """Token-bucket cap on EXTRA attempts (liveness retries + hedges) so
    retry storms cannot amplify an outage (docs/protocol.md §9).

    Each primary call earns ``ratio`` tokens (capped at ``burst``); every
    extra attempt spends one whole token via :meth:`take`. With the
    default ratio 0.1 a client in steady state retries at most ~10% extra
    load, with bursts of up to ``burst`` back-to-back retries when the
    bucket is full. Thread-safe: one budget may be shared by a client's
    retries and a fleet's hedges — total extra attempts stay bounded by
    the one bucket."""

    def __init__(self, ratio: float = 0.1, burst: int = 3,
                 initial: Optional[float] = None):
        if ratio < 0 or burst < 1:
            raise ValueError("retry budget needs ratio >= 0, burst >= 1")
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._tokens = self.burst if initial is None else float(initial)
        self._lock = threading.Lock()
        self.spent = 0                  # extra attempts granted
        self.denied = 0                 # extra attempts refused

    def note_primary(self) -> None:
        """A primary attempt happened: earn ``ratio`` tokens. Earning is
        unconditional — a bucket that ran dry refills from later primaries
        (every layer that drives primaries through a budget MUST call this
        on completion, not only on the admission branch; a dry bucket that
        never earns again disables its retries/hedges forever)."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def take(self) -> bool:
        """Spend one token for an extra attempt. → False (and the caller
        must NOT retry/hedge) when the bucket is dry."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent += 1
                return True
            self.denied += 1
            return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class TokenBucket:
    """Per-identity admission token bucket (docs/protocol.md §10).

    Continuous refill at ``rate`` tokens/second up to ``burst`` capacity,
    lazily computed from the monotonic clock (no refill thread). One
    request costs one token (batch/scatter envelopes cost one per item).
    :meth:`try_take` never blocks: it either admits (→ 0.0) or returns the
    ``retry_after`` seconds until the bucket holds enough tokens for this
    take — the hint sealed into the typed :class:`RateLimited` shed, so a
    well-behaved tenant converges onto its configured rate instead of
    hammering the admission check."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst < 1:
            raise ValueError("token bucket needs rate > 0, burst >= 1")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = self.burst
        self._stamp = time.monotonic()
        self._lock = threading.Lock()
        self.admitted = 0
        self.shed = 0

    def try_take(self, n: int = 1) -> float:
        """Charge ``n`` tokens. → 0.0 when admitted, else the seconds
        until the bucket refills enough for an ``n``-token take."""
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                self.admitted += n
                return 0.0
            self.shed += n
            return (n - self._tokens) / self.rate

    def tokens(self) -> float:
        with self._lock:
            return self._tokens


# Deficit replenished per round-robin round per unit weight, in request
# cost units (docs/protocol.md §10). Small enough that interleaving stays
# fine-grained, large enough that a weight-1 flow clears a single-item
# turn in one round.
WFQ_QUANTUM = 4


class WeightedFairQueue:
    """Deficit-round-robin work queue across flows (tenants / services).

    Classic DRR (docs/protocol.md §10): each flow with queued work holds a
    deficit counter; the flow at the head of the active ring dequeues while
    its head item's cost fits its deficit, a flow that cannot afford its
    head item earns ``quantum x weight(flow)`` and rotates to the ring
    tail, and a flow that empties leaves the ring forfeiting its remaining
    deficit (no banked credit for idle flows). Long-run service share is
    proportional to weight, and one flow's backlog can delay another flow
    by at most one max-cost item per round — the isolation property the
    sharded executor needs against a noisy tenant.

    Thread-safe; :meth:`pop` blocks. After :meth:`close`, pops drain
    whatever is queued and then return ``None`` (the shard shutdown
    contract)."""

    def __init__(self, weight_of: Optional[Callable[[object], float]] = None,
                 quantum: float = WFQ_QUANTUM):
        if quantum <= 0:
            raise ValueError("quantum must be > 0")
        self._weight_of = weight_of or (lambda key: 1.0)
        self.quantum = float(quantum)
        self._cv = threading.Condition()
        self._flows: "OrderedDict[object, deque]" = OrderedDict()
        self._deficit: Dict[object, float] = {}
        self._size = 0
        self._closed = False
        self.pushed = 0
        self.popped = 0
        self.rounds = 0                 # quantum replenishments handed out

    def push(self, item, key=None, cost: float = 1) -> None:
        with self._cv:
            q = self._flows.get(key)
            if q is None:
                q = self._flows[key] = deque()
                self._deficit[key] = 0.0
            q.append((item, max(0.0, float(cost))))
            self._size += 1
            self.pushed += 1
            self._cv.notify()

    def _pop_locked(self):
        while self._flows:
            key, q = next(iter(self._flows.items()))
            item, cost = q[0]
            if self._deficit[key] >= cost:
                q.popleft()
                self._deficit[key] -= cost
                self._size -= 1
                self.popped += 1
                if not q:               # empty flows forfeit their deficit
                    del self._flows[key]
                    del self._deficit[key]
                return (item, key)
            # head flow can't afford its item: one round's quantum, rotate.
            # Terminates: the deficit grows every visit, the cost doesn't.
            weight = max(1e-9, float(self._weight_of(key)))
            self._deficit[key] += self.quantum * weight
            self._flows.move_to_end(key)
            self.rounds += 1
        return None

    def pop(self, timeout: Optional[float] = None):
        """→ ``(item, key)`` in DRR order; ``None`` once closed AND
        drained (or on ``timeout``)."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                got = self._pop_locked()
                if got is not None:
                    return got
                if self._closed:
                    return None
                if end is None:
                    self._cv.wait()
                else:
                    rem = end - time.monotonic()
                    if rem <= 0:
                        return None
                    self._cv.wait(rem)

    def qsize(self) -> int:
        with self._cv:
            return self._size

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class _FairGate:
    """DRR turnstile bounding concurrent in-flight cost across tenants —
    the :class:`WeightedFairQueue` discipline applied to the fleet's
    replica in-flight slots instead of a work queue (docs/protocol.md
    §10). ``acquire(tenant, cost)`` blocks until the gate grants the
    cost under ``capacity``; grants among waiting tenants follow the same
    per-tenant deficit counters, so one tenant's cohort backlog cannot
    monopolize the replica slots: the moment a second tenant queues, slots
    free up to it in weight proportion. A cost larger than ``capacity``
    is clamped to it (charged identically on release), so an oversized
    cohort admits alone rather than deadlocking."""

    def __init__(self, capacity: float, *,
                 weight_of: Optional[Callable[[object], float]] = None,
                 quantum: float = WFQ_QUANTUM):
        if capacity < 1:
            raise ValueError("fair gate needs capacity >= 1")
        self.capacity = float(capacity)
        self._weight_of = weight_of or (lambda key: 1.0)
        self.quantum = float(quantum)
        self._cv = threading.Condition()
        self._inflight = 0.0
        self._waiting: "OrderedDict[object, deque]" = OrderedDict()
        self._deficit: Dict[object, float] = {}
        self.granted = 0
        self.queued_waits = 0           # acquires that had to park
        self.rounds = 0

    def _charge(self, cost: float) -> float:
        return min(max(1.0, float(cost)), self.capacity)

    def _grant_locked(self) -> None:
        while self._waiting and self._inflight < self.capacity:
            key, q = next(iter(self._waiting.items()))
            ticket = q[0]               # [granted, charge]
            charge = ticket[1]
            if self._inflight + charge > self.capacity:
                return                  # head of ring waits for a release
            if self._deficit[key] >= charge:
                q.popleft()
                self._deficit[key] -= charge
                if not q:
                    del self._waiting[key]
                    del self._deficit[key]
                self._inflight += charge
                ticket[0] = True
                self.granted += 1
                continue
            weight = max(1e-9, float(self._weight_of(key)))
            self._deficit[key] += self.quantum * weight
            self._waiting.move_to_end(key)
            self.rounds += 1

    def acquire(self, key, cost: float = 1,
                deadline: Optional[float] = None) -> bool:
        """Block until ``cost`` (clamped to capacity) is granted under the
        DRR discipline. → False when ``deadline`` passes first (nothing
        charged — the caller sheds typed)."""
        charge = self._charge(cost)
        with self._cv:
            if not self._waiting and self._inflight + charge <= self.capacity:
                self._inflight += charge    # fast path: nobody parked
                self.granted += 1
                return True
            ticket = [False, charge]
            q = self._waiting.get(key)
            if q is None:
                q = self._waiting[key] = deque()
                self._deficit[key] = 0.0
            q.append(ticket)
            self.queued_waits += 1
            self._grant_locked()
            while not ticket[0]:
                if deadline is None:
                    self._cv.wait()
                    continue
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                self._cv.wait(rem)
                if ticket[0]:
                    return True
            if ticket[0]:
                return True
            # timed out while parked: withdraw the ticket (never granted)
            q = self._waiting.get(key)
            if q is not None:
                try:
                    q.remove(ticket)
                except ValueError:
                    pass
                if not q:
                    self._waiting.pop(key, None)
                    self._deficit.pop(key, None)
            return False

    def release(self, cost: float = 1) -> None:
        with self._cv:
            self._inflight -= self._charge(cost)
            self._grant_locked()
            self._cv.notify_all()

    def inflight(self) -> float:
        with self._cv:
            return self._inflight


def _route(a: int, b: int, c: int) -> np.ndarray:
    return np.array([GW_MAGIC, a, b, c], "<u4").view(np.uint8)


def _batch_route(sid: int, cid: int, n: int) -> np.ndarray:
    return np.array([GW_BATCH_MAGIC, sid, cid, n], "<u4").view(np.uint8)


def _scatter_route(cid: int, n: int) -> np.ndarray:
    return np.array([GW_SCAT_MAGIC, cid, n, 0], "<u4").view(np.uint8)


def _payload(arr) -> torch.Tensor:
    """A caller's payload (a tensor on any device, or an array) as a
    contiguous tensor (framing's view of it)."""
    return framing._as_tensor(arr)


def _frame_nbytes(arr) -> int:
    t = _payload(arr)
    return t.numel() * t.element_size()


def _write_words(dst: torch.Tensor, words: Dict[int, int]) -> None:
    """Write u32 ``words`` (byte offset → value) into the uint8 tensor
    ``dst`` with one host-to-device copy of the values and the indices."""
    if not words:
        return
    idx = torch.tensor([o // 4 for o in words], dtype=torch.int64)
    val = torch.from_numpy(np.array(list(words.values()), "<u4").view(np.int32))
    if dst.is_cuda:
        idx, val = idx.to(dst.device), val.to(dst.device)
    dst.view(torch.int32)[idx] = val


def _frame_view(raw: torch.Tensor, ofs: int, nbytes: int) -> torch.Tensor:
    """``raw[ofs:ofs + nbytes]`` as a (rows, 128) uint32 frame. A frame
    that does not start 16-byte aligned (one that follows an error blob,
    padded to 4 bytes only) is copied to a fresh tensor first: the guard
    kernels read 16 bytes at a time."""
    body = raw[ofs:ofs + nbytes]
    if body.data_ptr() % 16:
        body = body.clone()
    return body.view(torch.uint32).reshape(-1, framing.LANES)


def _seal_envelope(route4, arr, *, seed: int, seq: int, device,
                   deadline_us: int = 0, priority: int = 0) -> torch.Tensor:
    """``[4 route words] + sealed frame`` assembled in ONE uint8 tensor on
    ``device`` — the frame is sealed in place behind the route words
    (``framing.seal_into``: the payload written once, ``fast_mac`` over
    it in place, the header last). Without ``framing.ZERO_COPY`` the
    frame is built apart and concatenated behind the route words."""
    t = _payload(arr)
    if not framing.ZERO_COPY:
        frame = framing.build_frame(t, seed=seed, seq=seq, device=device,
                                    deadline_us=deadline_us, priority=priority)
        return _join([np.array(route4, "<u4").view(np.uint8), frame], device)
    rows = framing.frame_rows(t.numel() * t.element_size())
    env = torch.empty(_ROUTE_BYTES + rows * framing.LANES * 4,
                      dtype=torch.uint8, device=device)
    env[:_ROUTE_BYTES].copy_(torch.from_numpy(np.array(route4, "<u4")
                                              .view(np.uint8)))
    framing.seal_into(env[_ROUTE_BYTES:].view(torch.uint32)
                      .reshape(rows, framing.LANES), t, seed=seed, seq=seq,
                      deadline_us=deadline_us, priority=priority)
    return env


def _join(parts, device) -> torch.Tensor:
    """Concatenate envelope parts — host byte arrays (route words, error
    blobs) and tensors (sealed frames) — into one uint8 tensor on
    ``device``, with ONE host-to-device copy of all the host parts."""
    host = [p for p in parts if isinstance(p, np.ndarray)]
    if len(host) == len(parts):
        return torch.from_numpy(np.concatenate(host))
    staged = torch.from_numpy(np.concatenate(host)).to(device) if host else None
    out, k = [], 0
    for p in parts:
        if isinstance(p, np.ndarray):
            out.append(staged[k:k + p.nbytes])
            k += p.nbytes
        else:
            out.append(p.reshape(-1).view(torch.uint8))
    return torch.cat(out)


def _error_parts(exc: BaseException) -> list:
    """A batch / scatter response item for a typed error: its item route
    and its msgpack blob padded to 4 bytes."""
    blob = _pack_error(exc)
    pad = (-len(blob)) % 4
    return [_route(_ERR, len(blob), 0),
            np.frombuffer(blob + b"\0" * pad, np.uint8)]


def _error_envelope(exc: BaseException, word: int) -> torch.Tensor:
    """The single-message error envelope (host bytes: the transport copies
    them into its response region)."""
    blob = _pack_error(exc)
    return torch.from_numpy(np.concatenate(
        [_route(_ERR, word, len(blob)), np.frombuffer(blob, np.uint8)]))


class _HostBytes:
    """Host reads of a uint8 envelope tensor for a walk: a window of
    ``_READ_AHEAD`` bytes is copied to the host at a time (one
    device-to-host copy serves every item header inside it)."""

    def __init__(self, raw: torch.Tensor, window: int = _READ_AHEAD):
        self.raw, self.window = raw, window
        self._lo, self._buf = 0, np.empty(0, np.uint8)

    def get(self, ofs: int, n: int) -> np.ndarray:
        """The bytes ``[ofs, ofs + n)`` (fewer past the end)."""
        if ofs < self._lo or ofs + n > self._lo + self._buf.size:
            self._lo = ofs
            self._buf = self.raw[ofs:ofs + max(n, self.window)].cpu().numpy()
        return self._buf[ofs - self._lo: ofs - self._lo + n]

    def words(self, ofs: int, n: int) -> List[int]:
        b = self.get(ofs, 4 * n)
        if b.size < 4 * n:
            raise framing.FrameError("truncated gateway envelope")
        return np.frombuffer(b.tobytes(), "<u4").tolist()


def _read_items(hb: "_HostBytes", n: int, what: str) -> list:
    """Walk the ``n`` items of a batch / scatter RESPONSE (read through
    ``hb``) → per item ``(status, body)``: the frame (aligned) and its
    header words for status 0, the error blob's bytes otherwise."""
    raw = hb.raw
    size = raw.numel()
    out, ofs = [], _ROUTE_BYTES
    for _ in range(n):
        if size < ofs + _ROUTE_BYTES:
            raise TransportError(f"truncated gateway {what} response")
        ih = hb.words(ofs, 4)
        if ih[0] != GW_MAGIC:
            raise TransportError(f"desynced gateway {what} response")
        status, nb = ih[1], ih[2]
        body = ofs + _ROUTE_BYTES
        if status == _OK:
            out.append((status, (_frame_view(raw, body, nb),
                                 hb.words(body, framing.LANES))))
        else:
            out.append((status, hb.get(body, nb).tobytes()))
        ofs = body + nb + ((-nb) % 4)
    return out


def _response_route(hb: "_HostBytes") -> List[int]:
    """The route words of a response envelope (checked)."""
    if hb.raw.numel() < _ROUTE_BYTES:
        raise TransportError("malformed gateway response (truncated)")
    route = hb.words(0, 4)
    if route[0] != GW_MAGIC:
        raise TransportError("malformed gateway response (bad magic)")
    return route


# a client method runs on its gateway transport's stream (the transports'
# ``_on_stream`` rule, for the gateway's own threads)
_on_transport_stream = _stream_method(lambda client: client.gw.transport.stream)


class _Shard:
    """One executor worker of the sharded gateway: a FIFO queue drained by
    a dedicated thread. Services are pinned to shards (``sid % workers``),
    so one service's work keeps its arrival order (per-channel ordering)
    while different services execute concurrently on different shards.

    Fault-injection signals (``HandlerCrash``/``DropResponse``) and any
    other ``BaseException`` are captured and re-raised on the *dispatching*
    session thread, so crash semantics are identical to inline execution
    (the session thread dies, the client gets an immediate typed
    ``ServiceCrashed``) and the shard itself keeps serving.

    ``context`` is entered by the shard thread for its whole life: the
    gateway passes its transport's ``on_stream``, so the guard and seal
    kernels a shard launches queue on the same stream as the transport's
    writes of the frames they read."""

    def __init__(self, idx: int,
                 weight_of: Optional[Callable[[object], float]] = None,
                 context: Optional[Callable] = None):
        self.idx = idx
        self._context = context
        self.executed = 0
        # DRR across tenants (docs/protocol.md §10): work is keyed by the
        # submitting identity, so one tenant's scatter backlog interleaves
        # fairly with other tenants' instead of head-of-line blocking the
        # shard thread. Unkeyed work (key=None) is its own weight-1 flow.
        self._q = WeightedFairQueue(weight_of=weight_of)
        self._closed = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"gw-shard-{idx}")
        self._thread.start()

    def _exec(self, item):
        fn, box, done = item
        try:
            box.append((True, fn()))
        except BaseException as e:          # noqa: B036 — relayed, not eaten
            box.append((False, e))
        finally:
            # the shard thread and close()-racing callers both execute
            # items — an unguarded += here drops counts
            with self._lock:
                self.executed += 1
            done.set()

    def _run(self):
        with (self._context() if self._context is not None
              else contextlib.nullcontext()):
            while True:
                got = self._q.pop()
                if got is None:
                    # close(): the WFQ drained everything already queued
                    # before reporting empty, so no dispatcher waits on a
                    # dead shard
                    return
                self._exec(got[0])

    def submit(self, fn, key=None, cost: float = 1):
        """Enqueue ``fn`` under tenant flow ``key`` with DRR ``cost``
        (item count for cohort groups); returns (box, done) — wait on
        ``done``, then ``box[0]`` is (ok, result-or-exception). A scatter
        racing ``close()`` executes inline on the caller (same semantics,
        no parallelism) instead of queueing behind the shutdown drain."""
        box: list = []
        done = threading.Event()
        item = (fn, box, done)
        with self._lock:
            if not self._closed:
                self._q.push(item, key=key, cost=cost)
                return box, done
        self._exec(item)                    # shard gone: run on the caller
        return box, done

    def close(self):
        with self._lock:
            self._closed = True
            self._q.close()

    def queued(self) -> int:
        return self._q.qsize()


def _own_result(res):
    """A result a client keeps, as a tensor that owns its memory. Verified
    payloads are views (of a guard copy, or of a response envelope that
    holds its neighbours too); a view is cloned so no result ever aliases
    storage the data plane hands out again."""
    if isinstance(res, torch.Tensor) and res._base is not None:
        return res.clone()
    return res


def _as_frameable(obj) -> torch.Tensor:
    """A handler's response (a tensor on any device, or an array) as a
    contiguous tensor framing can seal; unsupported dtypes and ranks
    travel as raw bytes. This must never fail: response sealing happens
    AFTER the channel sequence has advanced, so a sealing error would
    desync the channel instead of surfacing as a typed per-item error."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().contiguous()
    else:
        a = np.ascontiguousarray(np.asarray(obj))
        try:
            t = torch.from_numpy(a)
        except TypeError:               # a dtype torch has no type for
            t = torch.from_numpy(a.view(np.uint8).reshape(-1))
    if t.dtype not in framing._DTYPE_CODES or t.ndim > 4:
        t = t.reshape(-1).view(torch.uint8)
    return t


class ServiceHealth:
    """Per-service failure tracking + circuit breaker.

    States: ``closed`` (healthy) → ``open`` after ``threshold`` consecutive
    handler failures (requests are shed with a typed
    :class:`ServiceUnavailable` instead of hanging) → ``half_open`` after
    ``probe_after`` sheds (ONE probe request is let through; success closes
    the circuit, failure re-opens it). Counting sheds instead of wall-clock
    keeps chaos runs exactly replayable from a seed."""

    def __init__(self, threshold: int = 3, probe_after: int = 8):
        self.threshold = threshold
        self.probe_after = probe_after
        self.state = "closed"
        self.consecutive_failures = 0
        self.failures = 0               # lifetime handler failures
        self.crashes = 0                # lifetime handler-thread crashes
        self.sheds = 0                  # lifetime circuit rejections
        self.restarts = 0               # lifetime handler restarts
        self._shed_run = 0              # sheds since the circuit last opened
        self._lock = threading.Lock()

    def admit(self, service: str):
        """Gate a request. Raises ServiceUnavailable while the circuit is
        open (except for the half-open probe)."""
        with self._lock:
            if self.state == "closed":
                return
            if self.state == "open":
                if self._shed_run >= self.probe_after:
                    self.state = "half_open"    # this request is the probe
                    return
                self._shed_run += 1
                self.sheds += 1
                raise ServiceUnavailable(
                    f"service {service!r} circuit open "
                    f"({self.consecutive_failures} consecutive failures); "
                    f"shedding load ({self._shed_run}/{self.probe_after} "
                    f"before probe)")
            # half_open: another caller's probe is in flight; let it race —
            # both outcomes resolve the state below

    def success(self):
        with self._lock:
            self.consecutive_failures = 0
            self.state = "closed"
            self._shed_run = 0

    def failure(self, crashed: bool = False) -> bool:
        """Record a handler failure. → True when the breaker trips (the
        gateway then restarts the service if it can, else opens the
        circuit)."""
        with self._lock:
            self.failures += 1
            self.crashes += int(crashed)
            self.consecutive_failures += 1
            if self.state == "half_open":
                self.state = "open"
                self._shed_run = 0
                return True
            if self.state == "closed" \
                    and self.consecutive_failures >= self.threshold:
                return True
            return False

    def trip(self):
        with self._lock:
            self.state = "open"
            self._shed_run = 0

    def reset(self):
        with self._lock:
            self.state = "closed"
            self.consecutive_failures = 0
            self._shed_run = 0
            self.restarts += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"state": self.state,
                    "consecutive_failures": self.consecutive_failures,
                    "failures": self.failures, "crashes": self.crashes,
                    "sheds": self.sheds, "restarts": self.restarts}


class _Brownout:
    """Hysteretic overload controller for one service (protocol.md §9).

    Tracks an inflight gauge (admission → completion) and an EWMA of
    service time. Admission with the gauge at/above ``high_water`` — or,
    when configured, EWMA service time at/above ``high_water_ms`` —
    ENGAGES brownout: new admissions are shed with a typed
    :class:`Overloaded` carrying a ``retry_after`` backlog-drain estimate,
    instead of queueing into timeout collapse. Recovery is hysteretic:
    once engaged, sheds continue until the gauge drains to ``low_water``
    (and the EWMA, when gated on it, falls below ``high_water_ms``), so
    the controller cannot flap at the boundary."""

    def __init__(self, high_water: int = 64, low_water: Optional[int] = None,
                 high_water_ms: Optional[float] = None,
                 alpha: float = 0.2):
        if low_water is None:
            low_water = max(1, high_water // 2)
        if not (0 < low_water <= high_water):
            raise ValueError("brownout needs 0 < low_water <= high_water")
        self.high_water = int(high_water)
        self.low_water = int(low_water)
        self.high_water_ms = high_water_ms
        self.alpha = float(alpha)
        self.inflight = 0
        self.ewma_ms = 0.0
        self.engaged = False
        self.sheds = 0                  # admissions turned away
        self.engagements = 0            # times the high-water mark tripped
        self._lock = threading.Lock()

    def _over_high(self) -> bool:
        return (self.inflight >= self.high_water
                or (self.high_water_ms is not None
                    and self.ewma_ms >= self.high_water_ms))

    def _under_low(self) -> bool:
        return (self.inflight <= self.low_water
                and (self.high_water_ms is None
                     or self.ewma_ms < self.high_water_ms))

    def admit(self, name: str, weight: int = 1) -> None:
        """Gate an admission; on success the gauge is charged ``weight``
        and the caller MUST pair it with :meth:`done`."""
        with self._lock:
            if self.engaged:
                if self._under_low():
                    self.engaged = False
            elif self._over_high():
                self.engaged = True
                self.engagements += 1
            if self.engaged:
                self.sheds += weight
                retry_after = self.inflight * self.ewma_ms / 1e3
                raise Overloaded(
                    f"service {name!r} overloaded ({self.inflight} inflight, "
                    f"ewma {self.ewma_ms:.1f}ms; high water "
                    f"{self.high_water}); browning out new admissions",
                    retry_after=retry_after)
            self.inflight += weight

    def done(self, weight: int, elapsed_ms: float, ok: bool = True) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - weight)
            if ok:
                per = elapsed_ms / max(1, weight)
                a = self.alpha
                self.ewma_ms = per if self.ewma_ms == 0.0 else \
                    (1.0 - a) * self.ewma_ms + a * per

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"engaged": self.engaged, "inflight": self.inflight,
                    "ewma_ms": round(self.ewma_ms, 3), "sheds": self.sheds,
                    "engagements": self.engagements,
                    "high_water": self.high_water,
                    "low_water": self.low_water}


@dataclass
class _Service:
    sid: int
    name: str
    handler: Handler
    domain: ProtectionDomain
    server_key: DomainKey
    allow: Optional[Set[str]]       # client-name allow-list; None = any cert
    factory: Optional[Callable[[], Handler]] = None   # restart hook
    # overload brownout controller (None = admission never browns out);
    # installed via ServiceGateway.enable_brownout
    brownout: Optional[_Brownout] = None
    # optional native batch entry point: takes a list of payloads, returns a
    # same-length list of responses (EngineService.handler_batch feeds the
    # continuous-batching decode loop through this)
    batch_handler: Optional[Callable] = None
    health: ServiceHealth = field(default_factory=ServiceHealth)
    # cid → (idempotency token → response payload): a retried request whose
    # original DID execute is answered from here, never re-executed. The
    # window is per-client so one client's traffic can never evict another
    # client's pending-retry token (a client is serial: its own window only
    # needs to cover its own last few calls)
    done: "OrderedDict[int, OrderedDict[int, torch.Tensor]]" = \
        field(default_factory=OrderedDict)
    done_lock: threading.Lock = field(default_factory=threading.Lock)


_DONE_TOKENS = 16                   # dedup window depth per client
_DONE_CLIENTS = 256                 # client buckets kept per service (LRU)


@dataclass
class Channel:
    """One (client, service) grant: capability key + MAC seed + sequences.

    The two sequence counters advance in lock-step because the transport
    session is strictly request/response. If the transport fails between the
    server's increment and the client's (e.g. a response timeout), the
    channel is desynced — but the transport session poisons itself on
    timeout, so every later call fails loudly instead of mis-parsing;
    recovery is a fresh client."""
    cid: int
    sid: int
    service: str
    seed: int
    client_key: DomainKey
    seq: int = 0                    # client-side next sequence number
    server_seq: int = 0             # server-side expected sequence number
    slock: threading.Lock = field(default_factory=threading.Lock)


class ServiceGateway:
    """Dispatch table of named services over a single transport.

    ``device`` is where the transport keeps its regions and where envelopes
    are sealed and verified (``"cuda"`` by default; the tests pass
    ``"cpu"``); ``transport_kwargs`` go to the transport. The reference's
    ``mac_impl`` is not taken: every MAC runs on the guard kernels."""

    def __init__(self, transport: Union[str, type] = "mpklink_opt", *,
                 max_keys: int = 256, workers: int = 0,
                 transport_kwargs: Optional[dict] = None, device="cuda"):
        transport = _transport_class(transport)
        self.device = resolve(device)
        self.registry = KeyRegistry(max_keys=max_keys, seed=0x6A7E)
        self.ca = CertificateAuthority(self.registry)
        self._services: Dict[str, _Service] = {}
        self._by_sid: Dict[int, _Service] = {}
        self._channels: Dict[Tuple[int, int], Channel] = {}
        self._glock = threading.Lock()
        self._sid_counter = itertools.count(1)
        self._cid_counter = itertools.count(1)
        # workers=N: the sharded parallel executor — scatter envelopes fan
        # their items across N shard threads (service sid % N). workers=0
        # executes scatter items inline (sequentially) on the dispatching
        # session thread; single/batch envelopes are unaffected either way
        self.workers = workers
        # per-identity QoS state (docs/protocol.md §10): token buckets gate
        # admission, weights steer the WFQ shards / fleet fair gates, and
        # _cid_names resolves an envelope's client id back to its CA
        # identity (the tenant key) without re-walking the channel table
        self._tenant_buckets: Dict[str, TokenBucket] = {}
        self._tenant_weights: Dict[str, float] = {}
        self._cid_names: Dict[int, str] = {}
        self._mux: Optional["CallCoalescer"] = None
        self._fleets: Dict[str, "ServiceFleet"] = {}
        self.stats = {"requests": 0, "responses": 0, "macs_verified": 0,
                      "rejected": 0, "deduped": 0, "sheds": 0,
                      "restarts": 0, "crashes": 0, "scatter_envelopes": 0,
                      "expired": 0, "overloaded": 0, "rate_limited": 0}

        kwargs = dict(transport_kwargs or {})
        kwargs.setdefault("device", self.device)
        if isinstance(transport, type) and issubclass(transport, MPKLinkTransport):
            # one key table for link channels AND service domains
            kwargs.setdefault("registry", self.registry)
            kwargs.setdefault("ca", self.ca)
        self.transport: Transport = transport(self._dispatch, **kwargs)
        self._shards: List[_Shard] = [
            _Shard(i, weight_of=self._tenant_weight,
                   context=self.transport.on_stream) for i in range(workers)]

    # -- the snapshot a process transport sends to its service process ------
    def __getstate__(self):
        """The gateway as its service process receives it when its own
        transport is a process transport: everything the dispatch path
        reads, without the transport, the shards' threads and the coalescer
        (all of the parent's side). Locks arrive as fresh locks. A replica
        fleet drives transports of its own and does not cross."""
        if self._fleets:
            raise TypeError("a gateway with replica fleets cannot be sent to "
                            "a service process: its fleets drive transports "
                            "of the parent")
        state = self.__dict__.copy()
        state["transport"] = None
        state["_shards"] = len(self._shards)
        state["_mux"] = None
        return state

    def __setstate__(self, state):
        """Rebuild the shards in the service process, on the stream current
        while it unpickles (the child's own)."""
        n = state.pop("_shards")
        self.__dict__.update(state)
        context = None
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            context = lambda: torch.cuda.stream(stream)  # noqa: E731
        self._shards = [_Shard(i, weight_of=self._tenant_weight,
                               context=context) for i in range(n)]

    # -- service lifecycle --------------------------------------------------
    def register_service(self, name: str, handler: Handler,
                         allow: Optional[Set[str]] = None, *,
                         factory: Optional[Callable[[], Handler]] = None,
                         batch_handler: Optional[Callable] = None,
                         failure_threshold: int = 3,
                         probe_after: int = 8) -> int:
        """Enroll a service with the CA and give it its own protection
        domain. ``allow`` restricts which client names may open channels.
        ``factory`` makes the service self-healing: after
        ``failure_threshold`` consecutive handler failures the gateway
        replaces the handler with ``factory()``, bumps the domain epoch and
        lets still-certified clients re-key transparently. Without a
        factory the circuit opens instead and requests are shed with
        :class:`ServiceUnavailable` until a probe succeeds.
        ``batch_handler`` (list of payloads → same-length list of
        responses) lets a batch envelope execute as ONE native call —
        EngineService passes its handler_batch here so a batched prompt
        submission joins the decode slot grid as a single cohort."""
        with self._glock:
            if name in self._services:
                raise ValueError(f"service {name!r} already registered")
            enroll(self.ca, name)
            dom = self.registry.allocate_domain(f"svc:{name}")
            svc = _Service(next(self._sid_counter), name, handler, dom,
                           self.registry.issue_key(dom, RW),
                           set(allow) if allow is not None else None,
                           factory=factory, batch_handler=batch_handler,
                           health=ServiceHealth(failure_threshold,
                                                probe_after))
            self._services[name] = svc
            self._by_sid[svc.sid] = svc
            return svc.sid

    def restart_service(self, name: str) -> None:
        """Self-healing restart: swap in a fresh handler (via the service's
        factory, when present), bump the service-domain epoch so every
        outstanding key/frame on the domain goes stale (the PKRU-flush
        analogue), and re-key the service. Still-certified clients re-key
        transparently on their next call."""
        with self._glock:
            svc = self._services[name]     # lookup under the same lock the
            if svc.factory is not None:    # registration path mutates under
                svc.handler = svc.factory()
            self.registry.revoke(svc.server_key)          # epoch bump
            svc.server_key = self.registry.issue_key(svc.domain, RW)
            self.stats["restarts"] += 1
        svc.health.reset()

    def _rekey_service(self, name: str) -> None:
        """Bump the service-domain epoch and re-key the service WITHOUT
        swapping the handler — the fleet-membership analogue of
        :meth:`restart_service`'s key rotation. Every outstanding client
        key/frame on the domain goes stale; still-certified clients re-key
        transparently on their next call (ONE re-key, then traffic flows)."""
        with self._glock:
            svc = self._services[name]
            self.registry.revoke(svc.server_key)          # epoch bump
            svc.server_key = self.registry.issue_key(svc.domain, RW)

    # -- replica fleets ------------------------------------------------------
    def register_replica(self, name: str, handler: Handler, *,
                         transport: Union[str, type] = "mpklink_opt_proc",
                         transport_kwargs: Optional[dict] = None,
                         allow: Optional[Set[str]] = None,
                         router_seed: int = 0x524F5554,
                         failure_threshold: int = 3,
                         probe_after: int = 8) -> int:
        """Add one replica to service ``name``'s fleet (creating the fleet
        — and registering the service — on the first call). Returns the
        replica id.

        One service name maps to N replicas; each replica runs ``handler``
        behind its OWN transport instance (proc-backed by default: the
        handler executes in a child process over a per-session POSIX shm
        segment) with its own key registry, protection domain and epoch —
        a frame sealed for one replica's link fails every other replica's
        guard. The gateway-side fleet routes each request to one replica
        via seeded power-of-two-choices least-loaded routing (in-flight +
        EWMA service time, :class:`ReplicaRouter`); batch envelopes and
        auto-coalesced cohorts land WHOLE on one replica
        (:meth:`ServiceFleet.dispatch_batch` is the service's
        ``batch_handler``), so a cohort joins one replica's ring as one
        pipelined unit.

        Joining an existing fleet under live traffic bumps the service
        domain epoch (the membership change is a re-key event): every
        client re-keys transparently ONCE through the CA, after which the
        new replica is in the routing set. ``allow``/breaker options apply
        on the first call only (they configure the service, not the
        replica)."""
        with self._glock:
            fleet = self._fleets.get(name)
            creating = fleet is None
            if creating:
                if name in self._services:
                    raise ValueError(
                        f"service {name!r} already registered without a "
                        f"fleet — fleets and plain handlers don't mix")
                fleet = ServiceFleet(self, name, router_seed=router_seed)
                self._fleets[name] = fleet
        if creating:
            self.register_service(name, fleet.dispatch, allow,
                                  batch_handler=fleet.dispatch_batch,
                                  failure_threshold=failure_threshold,
                                  probe_after=probe_after)
        rid = fleet.add(handler, transport=transport,
                        transport_kwargs=transport_kwargs)
        if not creating:
            # join under live traffic: epoch bump → one transparent re-key
            self._rekey_service(name)
        return rid

    def fleet(self, name: str) -> "ServiceFleet":
        with self._glock:
            return self._fleets[name]

    def drain_replica(self, name: str, rid: int,
                      timeout: Optional[float] = 30.0) -> bool:
        """Drain one replica under live traffic: the router stops picking
        it immediately, admitted in-flight work completes, and its
        session/segment resources are recycled only once quiesced (the
        crash invariant). Blocks up to ``timeout`` for quiescence; → True
        when the replica reached QUIESCED (its resources are then released
        and the service epoch is bumped so the fleet membership change is
        a re-key event), False when it is still DRAINING (nothing is
        recycled; call again to keep waiting)."""
        fleet = self.fleet(name)
        if fleet.drain(rid, timeout=timeout):
            self._rekey_service(name)
            return True
        return False

    def fleet_stats(self) -> Dict[str, List[Dict[str, object]]]:
        """Per-service replica snapshots (for supervisors/monitoring and
        :func:`repro.runtime.elastic.plan_fleet_scaling`)."""
        with self._glock:
            fleets = dict(self._fleets)
        return {name: f.snapshot() for name, f in fleets.items()}

    def health(self) -> Dict[str, Dict[str, object]]:
        """Per-service health snapshot (for supervisors/monitoring)."""
        with self._glock:
            services = list(self._services.values())
        return {s.name: s.health.snapshot() for s in services}

    def start(self) -> "ServiceGateway":
        self.transport.start()
        return self

    def enable_coalescing(self, *, max_batch: int = 64,
                          max_wait_us: float = 300.0,
                          name: str = "gw:coalescer") -> "CallCoalescer":
        """Turn on the transparent auto-batching mux: concurrent inline
        ``GatewayClient.call()``s arriving within an adaptive window are
        folded into ONE scatter envelope / ONE transport round trip (see
        :class:`CallCoalescer` and docs/protocol.md §5.4). Register every
        service BEFORE calling this if services use allow-lists — the mux
        carrier identity (``name``) must be allowed, else those services'
        calls silently keep the direct path. Returns the mux (also wired
        into every client's ``call()``)."""
        if self._mux is not None:
            raise RuntimeError("coalescing already enabled on this gateway")
        self._mux = CallCoalescer(self, max_batch=max_batch,
                                  max_wait_us=max_wait_us, name=name)
        return self._mux

    def enable_brownout(self, service: str, *, high_water: int = 64,
                        low_water: Optional[int] = None,
                        high_water_ms: Optional[float] = None) -> _Brownout:
        """Install the hysteretic overload controller on ``service``
        (docs/protocol.md §9): admissions past ``high_water`` concurrent
        requests (or past ``high_water_ms`` EWMA service time, when given)
        are shed with a typed :class:`Overloaded` carrying a
        ``retry_after`` hint, instead of queueing into timeout collapse;
        sheds continue until the backlog drains to ``low_water`` (default
        ``high_water // 2`` — the hysteresis band). Returns the
        controller (``snapshot()`` for observability)."""
        with self._glock:
            svc = self._services[service]
            if svc.brownout is not None:
                raise RuntimeError(
                    f"brownout already enabled for service {service!r}")
            bo = _Brownout(high_water=high_water, low_water=low_water,
                           high_water_ms=high_water_ms)
            svc.brownout = bo
            return bo

    # -- multi-tenant QoS (docs/protocol.md §10) -----------------------------
    def set_rate_limit(self, identity: str, *, rate: float,
                       burst: Optional[float] = None) -> TokenBucket:
        """Install (or replace) the per-identity token bucket: ``identity``
        (the CA name) may sustain ``rate`` requests/second with bursts up
        to ``burst`` (default ``rate``). Envelopes past the bucket shed
        with typed :class:`RateLimited` carrying the refill ``retry_after``
        — BEFORE the breaker, brownout or any queue is charged, so a
        rate-limited tenant consumes nothing but the admission check."""
        bucket = TokenBucket(rate, burst if burst is not None else rate)
        with self._glock:
            self._tenant_buckets[identity] = bucket
        return bucket

    def set_tenant_weight(self, identity: str, weight: float) -> None:
        """Set ``identity``'s WFQ weight (default 1.0) — its long-run share
        of shard execution and fleet in-flight slots relative to other
        backlogged tenants (docs/protocol.md §10)."""
        if weight <= 0:
            raise ValueError("tenant weight must be > 0")
        with self._glock:
            self._tenant_weights[identity] = float(weight)

    def _tenant_weight(self, key) -> float:
        return self._tenant_weights.get(key, 1.0)

    def _admit_identity_name(self, name: Optional[str], n: int = 1) -> None:
        """Token-bucket admission for ``n`` request units under CA identity
        ``name``. Raises :class:`RateLimited` (with ``retry_after``) on
        shed; identities with no configured bucket always admit."""
        if name is None:
            return
        bucket = self._tenant_buckets.get(name)
        if bucket is None:
            return
        wait = bucket.try_take(n)
        if wait > 0.0:
            self._bump_n("rate_limited", n)
            raise RateLimited(
                f"identity {name!r} rate limited "
                f"({bucket.rate:g}/s, burst {bucket.burst:g})",
                retry_after=wait)

    def _admit_identity(self, cid: int, n: int = 1) -> None:
        """Envelope-side admission: resolve the client id to its CA
        identity and charge its bucket (see :meth:`_admit_identity_name`)."""
        self._admit_identity_name(self._cid_names.get(cid), n)

    def qos_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant bucket observability: admitted/shed counts and the
        current token level."""
        with self._glock:
            buckets = dict(self._tenant_buckets)
        return {name: {"rate": b.rate, "burst": b.burst,
                       "tokens": b.tokens(), "admitted": b.admitted,
                       "shed": b.shed}
                for name, b in buckets.items()}

    def close(self):
        if self._mux is not None:
            self._mux.close()
            self._mux = None
        self.transport.close()
        for sh in self._shards:
            sh.close()
        with self._glock:
            fleets = list(self._fleets.values())
        for f in fleets:
            f.close()

    def shard_stats(self) -> List[Dict[str, int]]:
        """Executor observability: per-shard executed/queued counts."""
        return [{"shard": sh.idx, "executed": sh.executed,
                 "queued": sh.queued()} for sh in self._shards]

    # -- client lifecycle ---------------------------------------------------
    def connect(self, client_name: str, *, retries: int = 0,
                backoff: float = 0.005,
                retry_budget: Optional["RetryBudget"] = None
                ) -> "GatewayClient":
        return GatewayClient(self, client_name, retries=retries,
                             backoff=backoff, retry_budget=retry_budget)

    def _open_channel(self, client: "GatewayClient", service: str) -> Channel:
        """Control plane: CA-checked issue of a client key on the service's
        domain + derivation of the per-(client, service) MAC seed."""
        svc = self._services.get(service)
        if svc is None:
            raise AccessViolation(f"unknown service {service!r}")
        if svc.allow is not None and client.name not in svc.allow:
            raise AccessViolation(
                f"client {client.name!r} not authorized for service {service!r}")
        rec = self.ca._services.get(client.name)
        if rec is None or not rec.verified or not self.ca.verify_cert(rec):
            raise AccessViolation(
                f"client {client.name!r} failed certificate check")
        key = self.registry.issue_key(svc.domain, RW)
        seed = mac_seed(svc.domain, self.registry.epoch(svc.domain)) \
            ^ self.ca.session_seed(client._kp.private, service)
        chan = Channel(client.cid, svc.sid, service, seed, key)
        with self._glock:
            old = self._channels.get((client.cid, svc.sid))
            self._channels[(client.cid, svc.sid)] = chan
            # cid → CA identity, the tenant key for QoS admission/WFQ
            self._cid_names[client.cid] = client.name
        if old is not None:             # re-key: retire the replaced grant
            self.registry.retire(old.client_key)
        return chan

    def revoke(self, client: "GatewayClient", service: Optional[str] = None):
        """Revoke a client's channel key(s). Bumps the service-domain epoch,
        so every stale key/frame on that domain fails the guard afterwards
        (other clients must re-open — the PKRU-flush analogue)."""
        with self._glock:
            doomed = [(k, ch) for k, ch in self._channels.items()
                      if k[0] == client.cid
                      and (service is None or ch.service == service)]
        for k, ch in doomed:
            self.registry.revoke(ch.client_key)
            with self._glock:
                self._channels.pop(k, None)
            client._channels.pop(ch.service, None)
            # the epoch bump stales every key on the domain, including the
            # service's own — the co-located service re-syncs immediately
            # (clients must re-open through the CA; GatewayClient.call does
            # this transparently for still-certified clients)
            svc = self._by_sid[ch.sid]
            svc.server_key = self.registry.issue_key(svc.domain, RW)

    def _release_client(self, client: "GatewayClient"):
        """Graceful disconnect: retire the client's keys (no epoch bump —
        closing is not a security event) and drop its routing entries, so a
        closed client's cid can never dispatch again."""
        with self._glock:
            doomed = [(k, ch) for k, ch in self._channels.items()
                      if k[0] == client.cid]
            for k, ch in doomed:
                self._channels.pop(k, None)
            self._cid_names.pop(client.cid, None)
        for _, ch in doomed:
            self.registry.retire(ch.client_key)

    # -- data plane (runs on the transport's per-session service threads) ----
    def _bump(self, *stats: str):
        with self._glock:
            for s in stats:
                self.stats[s] += 1

    def _bump_n(self, stat: str, n: int):
        with self._glock:
            self.stats[stat] += n

    def _service_failure(self, svc: _Service, crashed: bool = False):
        """Record a handler failure; when the breaker trips, self-heal by
        restarting (factory available) or open the circuit and shed."""
        if crashed:
            self._bump("crashes")
        if svc.health.failure(crashed=crashed):
            if svc.factory is not None:
                self.restart_service(svc.name)
            else:
                svc.health.trip()

    def note_wire_crash(self, sid: int):
        """A transport-level crash was observed for a request routed to
        ``sid`` before it reached dispatch (fault fabrics call this so the
        gateway's health view includes wire-level kills)."""
        svc = self._by_sid.get(sid)
        if svc is not None:
            self._service_failure(svc, crashed=True)

    def _dedup_get(self, svc: _Service, cid: int, token: int):
        if not token:
            return None
        with svc.done_lock:
            bucket = svc.done.get(cid)
            return bucket.get(token) if bucket is not None else None

    def _dedup_put(self, svc: _Service, cid: int, token: int,
                   resp: torch.Tensor):
        if not token:
            return
        # the window outlives the request: a response may view the request
        # (an echo), and a request may view a ring slot that the transport
        # hands out again — the window keeps its own copy
        resp = resp.clone()
        with svc.done_lock:
            bucket = svc.done.setdefault(cid, OrderedDict())
            bucket[token] = resp
            while len(bucket) > _DONE_TOKENS:
                bucket.popitem(last=False)
            svc.done.move_to_end(cid)
            while len(svc.done) > _DONE_CLIENTS:
                svc.done.popitem(last=False)

    def _run_guarded(self, svc: _Service, payload: torch.Tensor,
                     deadline: Optional[float] = None,
                     identity: Optional[str] = None,
                     priority: int = framing.PRIO_NORMAL) -> torch.Tensor:
        """Run the handler behind the circuit breaker with failure
        accounting — the one execution core shared by the single, batch
        and scatter paths, so breaker semantics cannot diverge.

        Deadline shed comes FIRST and outside the try block: expired work
        is dropped before execution (docs/protocol.md §9) and a shed is
        neither a handler failure (no breaker charge) nor a brownout
        admission. Rate-limit sheds (docs/protocol.md §10) happen in the
        dispatch layer BEFORE this core is reached, so a ``RateLimited``
        tenant never charges the breaker or brownout either. While the
        handler runs, the propagated deadline and the caller's QoS context
        (CA identity + frame priority class) are published thread-locally
        (``current_deadline`` / ``current_identity`` / ``current_priority``)
        so downstream hops (fleet dispatch, EngineService admission)
        compute against them."""
        if deadline is not None and time.monotonic() >= deadline:
            self._bump("expired")
            raise DeadlineExpired(
                f"service {svc.name!r}: propagated deadline expired "
                "before execution")
        svc.health.admit(svc.name)      # circuit breaker: shed, don't hang
        bo = svc.brownout
        if bo is not None:
            try:
                bo.admit(svc.name)      # raises typed Overloaded when shed
            except Overloaded:
                self._bump("overloaded")
                raise
        prev = _push_deadline(deadline)
        qprev = _push_qos(identity, priority)
        t0 = time.perf_counter()
        ok = False
        try:
            resp = _as_frameable(svc.handler(payload))
            ok = True
        except HandlerCrash:
            # kills the transport service thread (by design) — record it,
            # then let it propagate past the per-request except nets
            self._service_failure(svc, crashed=True)
            raise
        except Exception:
            self._service_failure(svc)
            raise
        finally:
            _pop_qos(qprev)
            _pop_deadline(prev)
            if bo is not None:
                bo.done(1, (time.perf_counter() - t0) * 1e3, ok=ok)
        svc.health.success()
        return resp

    def _invoke(self, svc: _Service, chan: Channel, cid: int, token: int,
                fseq: int, payload: torch.Tensor,
                deadline: Optional[float] = None,
                priority: int = framing.PRIO_NORMAL) -> torch.Tensor:
        """Run the service handler behind the circuit breaker + dedup cache.
        Returns the response payload; updates ``chan.server_seq``."""
        cached = self._dedup_get(svc, cid, token)
        if cached is not None:
            # the original executed but its response was lost in flight:
            # answer from the dedup window, never re-execute. The window
            # only ever moves FORWARD — a replayed old envelope gets its
            # (already-delivered) answer but cannot rewind the channel
            # and desync legitimate in-order traffic
            self._bump("deduped")
            chan.server_seq = max(chan.server_seq,
                                  (fseq + 1) & 0xFFFFFFFF)
            return cached
        if fseq != chan.server_seq:
            raise framing.FrameError(
                f"sequence mismatch (got {fseq}, want {chan.server_seq})")
        resp = self._run_guarded(svc, payload, deadline,
                                 identity=self._cid_names.get(cid),
                                 priority=priority)
        self._dedup_put(svc, cid, token, resp)
        chan.server_seq = (fseq + 1) & 0xFFFFFFFF
        return resp

    def _invoke_batch(self, svc: _Service, chan: Channel, parsed,
                      deadlines=None, priorities=None,
                      identity: Optional[str] = None) -> list:
        """Execute a verified batch. ``parsed`` holds payload arrays with
        FrameError objects in failed positions (verify_batch strict=False);
        those pass through untouched. Every consumed item advances
        ``chan.server_seq`` positionally — success or failure — matching
        the client's batch-wide sequence advance (unlike the single path,
        where a failed exchange advances neither side). Health/circuit
        accounting: per item on the loop path, once per batch on the
        native ``batch_handler`` path. ``deadlines`` (absolute monotonic,
        positional, ``None`` = unbounded) shed expired items pre-execution
        with a per-slot ``DeadlineExpired``; the batch handler runs under
        the cohort's TIGHTEST live deadline (thread-local), matching the
        coalescer's budget model. ``priorities`` (positional lane-12
        classes) publish the cohort's MOST URGENT live class thread-locally
        on the native path — same "tightest wins" rule as the deadline."""
        if deadlines is None:
            deadlines = [None] * len(parsed)
        if priorities is None:
            priorities = [framing.PRIO_NORMAL] * len(parsed)
        results = list(parsed)
        now = time.monotonic()
        good = []
        for i, p in enumerate(parsed):
            if isinstance(p, framing.FrameError):
                continue
            if deadlines[i] is not None and now >= deadlines[i]:
                self._bump("expired")
                results[i] = DeadlineExpired(
                    f"service {svc.name!r}: propagated deadline expired "
                    "before execution")
                continue
            good.append((i, p))
        if svc.batch_handler is not None and good:
            bo = svc.brownout
            live = [d for i, _ in good
                    if (d := deadlines[i]) is not None]
            prev = _push_deadline(min(live) if live else None)
            qprev = _push_qos(identity,
                              min((priorities[i] for i, _ in good),
                                  key=priority_rank))
            t0 = time.perf_counter()
            bok = False
            admitted = False
            try:
                svc.health.admit(svc.name)
                if bo is not None:
                    try:
                        bo.admit(svc.name, weight=len(good))
                    except Overloaded:
                        self._bump("overloaded")
                        raise
                    admitted = True
                outs = svc.batch_handler([p for _, p in good])
                if len(outs) != len(good):
                    raise TransportError(
                        f"batch handler returned {len(outs)} responses "
                        f"for {len(good)} requests")
                svc.health.success()
                bok = True
                # a batch handler may return a typed exception INSTANCE in
                # an item's slot (a fleet replica's per-item remote error)
                # — it becomes that item's typed error, like the loop path
                for (i, _), o in zip(good, outs):
                    results[i] = o if isinstance(o, BaseException) \
                        else _as_frameable(o)
            except HandlerCrash:
                self._service_failure(svc, crashed=True)
                raise
            except ServiceUnavailable as e:     # circuit shed, not a
                self._bump("sheds")             # handler failure
                for i, _ in good:
                    results[i] = e
            except Exception as e:
                self._service_failure(svc)
                for i, _ in good:
                    results[i] = e
            finally:
                _pop_qos(qprev)
                _pop_deadline(prev)
                if bo is not None and admitted:
                    bo.done(len(good), (time.perf_counter() - t0) * 1e3,
                            ok=bok)
        else:
            for i, p in good:
                try:
                    results[i] = self._run_guarded(svc, p, deadlines[i],
                                                   identity=identity,
                                                   priority=priorities[i])
                except ServiceUnavailable as e:
                    self._bump("sheds")
                    results[i] = e
                except Exception as e:      # failure already recorded
                    results[i] = e
        chan.server_seq = (chan.server_seq + len(parsed)) & 0xFFFFFFFF
        return results

    def _dispatch_batch(self, raw: torch.Tensor, route: List[int]) -> torch.Tensor:
        """Serve one batch envelope: route/capability checks once, frame
        walk (split_frames), ONE batched MAC verify (``mac_batch``),
        per-item execution, ONE batched response seal. Per-item failures
        come back as typed error blobs in that item's slot; whole-batch
        failures use the single-message error envelope."""
        sid = 0
        try:
            sid, cid, n_items = route[1], route[2], route[3]
            svc = self._by_sid.get(sid)
            if svc is None:
                raise AccessViolation(f"unknown service id {sid}")
            chan = self._channels.get((cid, sid))
            if chan is None:
                raise AccessViolation(
                    f"client {cid} holds no key for service {svc.name!r}")
            # token-bucket admission: one unit per item, BEFORE the channel
            # lock or any sequence slot is consumed — a rate-limited batch
            # sheds whole with typed RateLimited and leaves nothing charged
            self._admit_identity(cid, n_items)
            with chan.slock:
                self.registry.check(chan.client_key, WRITE)
                self.registry.check(svc.server_key, READ)
                body = raw[_ROUTE_BYTES:]
                if body.numel() == 0 or body.numel() % (framing.LANES * 4):
                    raise framing.FrameError(
                        "malformed batch — truncated or not lane-aligned")
                frames = framing.split_frames(
                    body.view(torch.uint32).reshape(-1, framing.LANES))
                if len(frames) != n_items:
                    raise framing.FrameError(
                        f"batch declares {n_items} frames, found {len(frames)}")
                start = chan.server_seq
                seqs = [(start + i) & 0xFFFFFFFF for i in range(len(frames))]
                headers = framing.header_rows(frames)
                parsed = framing.verify_batch(frames, seed=chan.seed,
                                              seqs=seqs, strict=False,
                                              headers=headers)
                n_ok = sum(1 for p in parsed
                           if not isinstance(p, framing.FrameError))
                self._bump_n("requests", len(frames))
                self._bump_n("macs_verified", n_ok)
                self._bump_n("rejected", len(frames) - n_ok)
                # deadline words are MAC-covered: only trust them on
                # frames that verified (FrameError slots get None)
                deadlines = [None if isinstance(p, framing.FrameError)
                             else _frame_deadline(h)
                             for h, p in zip(headers, parsed)]
                priorities = [framing.PRIO_NORMAL
                              if isinstance(p, framing.FrameError)
                              else _frame_priority(h)
                              for h, p in zip(headers, parsed)]
                results = self._invoke_batch(svc, chan, parsed, deadlines,
                                             priorities,
                                             self._cid_names.get(cid))
                try:
                    self.registry.check(svc.server_key, WRITE)
                    self.registry.check(chan.client_key, READ)
                except AccessViolation as e:
                    # the epoch moved UNDER this batch (e.g. its own
                    # failures tripped a self-healing restart). Handlers
                    # already ran, so the client must NOT transparently
                    # re-key and resend — tag the rejection so call_batch's
                    # stale-epoch retry stands down (batches carry no
                    # idempotency token; a resend would double-execute)
                    raise AccessViolation(f"post-execution: {e}") from None
                ok_idx = [i for i, r in enumerate(results)
                          if not isinstance(r, BaseException)]
                rframes = framing.seal_batch(
                    [results[i] for i in ok_idx], seed=chan.seed,
                    seqs=[seqs[i] for i in ok_idx],
                    device=raw.device) if ok_idx else []
            parts = [_route(_BOK, sid, len(results))]
            rit = iter(rframes)
            for r in results:
                if isinstance(r, BaseException):
                    parts += _error_parts(r)
                else:
                    rf = next(rit).reshape(-1).view(torch.uint8)
                    parts.append(_route(_OK, rf.numel(), 0))
                    parts.append(rf)
            self._bump_n("responses", len(ok_idx))
            self._bump_n("rejected",
                         len(results) - len(ok_idx)
                         - sum(1 for p in parsed
                               if isinstance(p, framing.FrameError)))
            return _join(parts, raw.device)
        except Exception as e:
            self._bump(*(("rejected", "sheds")
                         if isinstance(e, ServiceUnavailable)
                         else ("rejected",)))
            return _error_envelope(e, sid)

    def _scatter_group(self, cid: int, sid: int, members) -> list:
        """Execute one channel's scatter items — the single-call pipeline
        (capability checks, MAC verify, dedup window, breaker) — with the
        batch envelope's positional sequence discipline: every consumed
        item advances the channel, success or failure, so one bad item
        cannot desync its neighbours. ``members`` is [(item_index, token,
        frame, header words), ...] in envelope order; returns
        [(item_index, response_frame | exception), ...]. Runs on the
        service's shard (concurrently with other services' groups) or
        inline when workers=0 — same semantics either way.

        Cohort admission: when the service registered a ``batch_handler``,
        the group's runnable items (verified, fresh, not dedup-answered)
        execute as ONE native batch call behind ONE breaker admission —
        exactly the batch envelope's execution model, which is how an
        auto-coalesced cohort of inline inference calls joins
        EngineService's continuous-batching decode grid as one unit.
        Per-item typed errors are unchanged either way."""
        svc = self._by_sid.get(sid)
        if svc is None:
            e = AccessViolation(f"unknown service id {sid}")
            return [(m[0], e) for m in members]
        chan = self._channels.get((cid, sid))
        if chan is None:
            e = AccessViolation(
                f"client {cid} holds no key for service {svc.name!r}")
            return [(m[0], e) for m in members]
        out = []
        ok: list = []                   # (idx, seq, response payload)
        identity = self._cid_names.get(cid)
        with chan.slock:
            base = chan.server_seq
            saw_fresh = False
            parseable = 0
            runnable: list = []         # (idx, token, fseq, payload, dl, pr)
            try:
                for k, (idx, token, frame, hdr) in enumerate(members):
                    try:
                        self.registry.check(chan.client_key, WRITE)
                        self.registry.check(svc.server_key, READ)
                        # MAC first, sequence word read afterwards: like
                        # the single path, the dedup window is consulted
                        # BEFORE the sequence check, so a replayed
                        # envelope (lost response + same-token retry) is
                        # answered from the window instead of tripping a
                        # mismatch
                        payload = framing.parse_frame(
                            frame, seed=chan.seed, expect_seq=None,
                            header=hdr)
                        fseq = hdr[2]
                        parseable += 1
                        if fseq == (base + k) & 0xFFFFFFFF:
                            saw_fresh = True    # at-position item: this is
                        self._bump("macs_verified")     # a FRESH envelope
                        cached = self._dedup_get(svc, cid, token)
                        if cached is not None:
                            self._bump("deduped")
                            ok.append((idx, fseq, cached))
                            continue
                        if fseq != (base + k) & 0xFFFFFFFF:
                            raise framing.FrameError(
                                f"sequence mismatch (got {fseq}, want "
                                f"{(base + k) & 0xFFFFFFFF})")
                        runnable.append((idx, token, fseq, payload,
                                         _frame_deadline(hdr),
                                         _frame_priority(hdr)))
                    except ServiceUnavailable as e:
                        self._bump("sheds")
                        out.append((idx, e))
                    except Exception as e:
                        out.append((idx, e))
                if svc.batch_handler is not None and runnable:
                    # shed expired items BEFORE the cohort admission, so
                    # one stale straggler cannot ride the native batch
                    now = time.monotonic()
                    live = []
                    for item in runnable:
                        if item[4] is not None and now >= item[4]:
                            self._bump("expired")
                            out.append((item[0], DeadlineExpired(
                                f"service {svc.name!r}: propagated "
                                "deadline expired before execution")))
                        else:
                            live.append(item)
                    if live:
                        self._scatter_run_batch(svc, chan, cid, live,
                                                ok, out, identity)
                else:
                    for idx, token, fseq, payload, dl, pr in runnable:
                        try:
                            # re-consult the window: an EARLIER item of this
                            # very envelope may have executed this token
                            # (duplicate tokens in one envelope must not
                            # double-execute, same as sequential items)
                            resp = self._dedup_get(svc, cid, token)
                            if resp is not None:
                                self._bump("deduped")
                            else:
                                resp = self._run_guarded(svc, payload, dl,
                                                         identity=identity,
                                                         priority=pr)
                                self._dedup_put(svc, cid, token, resp)
                            self.registry.check(svc.server_key, WRITE)
                            self.registry.check(chan.client_key, READ)
                            ok.append((idx, fseq, resp))
                        except ServiceUnavailable as e:
                            self._bump("sheds")
                            out.append((idx, e))
                        except Exception as e:
                            out.append((idx, e))
            finally:
                # positional discipline, decided per ENVELOPE: any item
                # sitting at its expected position marks the envelope
                # fresh, and a fresh envelope consumes len(members) slots
                # unconditionally — success, handler failure, or a corrupt
                # item ANYWHERE (the client advances for every item, so a
                # failing tail must not leave the server behind). A pure
                # replay (every parseable item stale) moves nothing:
                # forward-only, a resend can never rewind or further
                # desync the channel. Also runs on a crash unwinding,
                # where the session dies and the client re-keys via heal()
                if saw_fresh or parseable == 0:
                    chan.server_seq = (base + len(members)) & 0xFFFFFFFF
            if ok:                      # ONE batched seal pass per group
                rframes = framing.seal_batch(
                    [r for _, _, r in ok], seed=chan.seed,
                    seqs=[q for _, q, _ in ok], device=members[0][2].device)
                out.extend((idx, rf) for (idx, _, _), rf in zip(ok, rframes))
        return out

    def _scatter_run_batch(self, svc: _Service, chan: Channel, cid: int,
                           runnable: list, ok: list, out: list,
                           identity: Optional[str] = None) -> None:
        """Execute a scatter channel-group's runnable items as ONE native
        ``batch_handler`` call (the batch envelope's execution model):
        one breaker admission, one cohort submission — per-item dedup
        recording and post-execution capability checks preserved. The
        cohort's tightest deadline AND most-urgent priority class publish
        thread-locally for the handler's downstream hops. Called under
        ``chan.slock``."""
        # duplicate tokens inside one envelope execute ONCE (the sequential
        # semantics): only each token's first occurrence enters the native
        # batch; later duplicates are answered from its response below
        first_of: Dict[int, int] = {}       # token → index into `unique`
        unique: list = []
        slot_of: list = []                  # runnable position → unique pos
        for item in runnable:
            token = item[1]
            if token and token in first_of:
                slot_of.append(first_of[token])
                continue
            if token:
                first_of[token] = len(unique)
            slot_of.append(len(unique))
            unique.append(item)
        outs = None
        bo = svc.brownout
        live = [d for item in unique if (d := item[4]) is not None]
        prev = _push_deadline(min(live) if live else None)
        qprev = _push_qos(identity,
                          min((item[5] for item in unique),
                              key=priority_rank))
        t0 = time.perf_counter()
        bok = False
        admitted = False
        try:
            svc.health.admit(svc.name)
            if bo is not None:
                try:
                    bo.admit(svc.name, weight=len(unique))
                except Overloaded:
                    self._bump("overloaded")
                    raise
                admitted = True
            outs = svc.batch_handler([p for _, _, _, p, _, _ in unique])
            if len(outs) != len(unique):
                raise TransportError(
                    f"batch handler returned {len(outs)} responses "
                    f"for {len(unique)} requests")
            svc.health.success()
            bok = True
        except HandlerCrash:
            self._service_failure(svc, crashed=True)
            raise
        except ServiceUnavailable as e:     # circuit shed, not a failure
            self._bump("sheds")
            out.extend((idx, e) for idx, *_ in runnable)
            return
        except Exception as e:
            self._service_failure(svc)
            out.extend((idx, e) for idx, *_ in runnable)
            return
        finally:
            _pop_qos(qprev)
            _pop_deadline(prev)
            if bo is not None and admitted:
                bo.done(len(unique), (time.perf_counter() - t0) * 1e3,
                        ok=bok)
        for (idx, token, fseq, _, _, _), k in zip(runnable, slot_of):
            if isinstance(outs[k], BaseException):
                # per-item typed error from the batch handler (a fleet
                # replica's remote failure): this item's fate, not dedup'd
                out.append((idx, outs[k]))
                continue
            try:
                resp = _as_frameable(outs[k])
                self._dedup_put(svc, cid, token, resp)
                self.registry.check(svc.server_key, WRITE)
                self.registry.check(chan.client_key, READ)
                ok.append((idx, fseq, resp))
            except Exception as e:          # noqa: PERF203 — per-item fate
                out.append((idx, e))

    def _dispatch_scatter(self, raw: torch.Tensor,
                          route: List[int]) -> torch.Tensor:
        """Serve one scatter envelope: walk the per-item (route + frame)
        items (their headers read through one host window), group items
        by (client, service) channel preserving envelope order, execute
        every group on its service's shard — concurrently across shards,
        inline when workers=0 — and assemble per-item responses in the
        batch envelope's item layout. Whole-envelope failures (desynced
        walk, bad counts) use the single error envelope and consume no
        sequence numbers."""
        cid = 0
        try:
            cid, n_items = route[1], route[2]
            if n_items <= 0 or n_items > _MAX_SCATTER:
                raise framing.FrameError(
                    f"scatter envelope declares {n_items} items")
            size = raw.numel()
            if size % 4:
                raise framing.FrameError("scatter envelope not word-aligned")
            hb = _HostBytes(raw)
            items = []
            ofs = _ROUTE_BYTES
            for _ in range(n_items):
                if ofs + _HEAD_BYTES > size:
                    raise framing.FrameError("truncated scatter envelope")
                w = hb.words(ofs, 4 + framing.LANES)
                if w[0] != GW_MAGIC:
                    raise framing.FrameError(
                        f"scatter item walk desynced at word {ofs // 4}")
                sid, token, hdr = w[1], w[2], w[4:]
                if hdr[0] != framing.MAGIC:
                    raise framing.FrameError(
                        "scatter item is not an MPKLink frame")
                rows = framing.frame_rows(hdr[3])
                end = ofs + _ROUTE_BYTES + rows * framing.LANES * 4
                if end > size:
                    raise framing.FrameError(
                        f"scatter item declares {rows} rows past envelope end")
                items.append((sid, token,
                              _frame_view(raw, ofs + _ROUTE_BYTES,
                                          end - ofs - _ROUTE_BYTES), hdr))
                ofs = end
            if ofs != size:
                raise framing.FrameError("trailing bytes after scatter items")
            # token-bucket admission, one unit per item: the whole envelope
            # sheds typed BEFORE any group runs or any channel's sequence
            # slots are consumed (a RateLimited scatter is fully replayable)
            self._admit_identity(cid, n_items)
            self._bump("scatter_envelopes")
            self._bump_n("requests", n_items)
            groups: "OrderedDict[int, list]" = OrderedDict()
            for idx, (sid, token, frame, hdr) in enumerate(items):
                groups.setdefault(sid, []).append((idx, token, frame, hdr))
            results: list = [None] * n_items
            pending = []
            tenant = self._cid_names.get(cid)
            for sid, members in groups.items():
                fn = (lambda s=sid, m=members: self._scatter_group(cid, s, m))
                if self._shards:
                    # WFQ flow = the submitting tenant, cost = group size:
                    # one tenant's cohort backlog interleaves fairly with
                    # other tenants' work on the shard (protocol.md §10)
                    pending.append(
                        self._shards[sid % len(self._shards)]
                        .submit(fn, key=tenant, cost=len(members)))
                else:
                    pending.append(([(True, fn())], None))
            for box, done in pending:
                if done is not None:
                    done.wait()
                ok, val = box[0]
                if not ok:
                    raise val       # HandlerCrash / DropResponse relayed
                for idx, r in val:
                    results[idx] = r
            parts = [np.array([GW_MAGIC, _SOK, cid, n_items], "<u4")
                     .view(np.uint8)]
            n_ok = 0
            for r in results:
                if isinstance(r, BaseException):
                    parts += _error_parts(r)
                else:
                    rf = r.reshape(-1).view(torch.uint8)
                    parts.append(_route(_OK, rf.numel(), 0))
                    parts.append(rf)
                    n_ok += 1
            self._bump_n("responses", n_ok)
            self._bump_n("rejected", n_items - n_ok)
            return _join(parts, raw.device)
        except Exception as e:
            self._bump(*(("rejected", "sheds")
                         if isinstance(e, ServiceUnavailable)
                         else ("rejected",)))
            return _error_envelope(e, cid)

    def _dispatch(self, req) -> torch.Tensor:
        """The transport handler: one envelope (uint8 bytes on the
        transport's device) → one response envelope. The route words and
        the inner frame's header row reach the host in ONE copy."""
        sid = 0
        try:
            raw = _payload(req).reshape(-1).view(torch.uint8)
            if raw.numel() < _ROUTE_BYTES:
                raise framing.FrameError("short gateway envelope")
            head = raw[:_HEAD_BYTES].cpu().numpy()
            route = np.frombuffer(head[:_ROUTE_BYTES].tobytes(), "<u4").tolist()
            if route[0] == GW_BATCH_MAGIC:
                return self._dispatch_batch(raw, route)
            if route[0] == GW_SCAT_MAGIC:
                return self._dispatch_scatter(raw, route)
            if route[0] != GW_MAGIC:
                raise framing.FrameError("not a gateway envelope (bad magic)")
            sid, cid, token = route[1], route[2], route[3]
            svc = self._by_sid.get(sid)
            if svc is None:
                raise AccessViolation(f"unknown service id {sid}")
            chan = self._channels.get((cid, sid))
            if chan is None:
                raise AccessViolation(
                    f"client {cid} holds no key for service {svc.name!r}")
            # per-identity token bucket (docs/protocol.md §10): shed typed
            # BEFORE the channel lock / sequence slot — a rate-limited call
            # charges nothing downstream (no breaker, brownout or dedup)
            self._admit_identity(cid)
            with chan.slock:
                # PKRU staging checks: the client may write the request
                # region, the service may read it (revocation/epoch enforced)
                self.registry.check(chan.client_key, WRITE)
                self.registry.check(svc.server_key, READ)
                body = raw[_ROUTE_BYTES:]
                if body.numel() == 0 or body.numel() % (framing.LANES * 4):
                    raise framing.FrameError(
                        "malformed frame — truncated or not lane-aligned")
                frame = body.view(torch.uint32).reshape(-1, framing.LANES)
                hdr = np.frombuffer(head[_ROUTE_BYTES:].tobytes(),
                                    "<u4").tolist()
                # MAC/seed/header verification first (expect_seq=None: the
                # sequence check is downstream so an idempotent retry of an
                # already-executed request can be answered from the dedup
                # window); the sequence word is read afterwards
                payload = framing.parse_frame(frame, seed=chan.seed,
                                              expect_seq=None, header=hdr)
                fseq = hdr[2]
                self._bump("requests", "macs_verified")
                resp = self._invoke(svc, chan, cid, token, fseq, payload,
                                    _frame_deadline(hdr),
                                    _frame_priority(hdr))
                self.registry.check(svc.server_key, WRITE)
                self.registry.check(chan.client_key, READ)
                # response frame sealed in place behind the route words —
                # ONE buffer, no build/concat chain
                env = _seal_envelope([GW_MAGIC, _OK, sid, 0], resp,
                                     seed=chan.seed, seq=fseq,
                                     device=raw.device)
            self._bump("responses")
            return env
        except Exception as e:
            self._bump(*(("rejected", "sheds")
                         if isinstance(e, ServiceUnavailable)
                         else ("rejected",)))
            return _error_envelope(e, sid)


class GatewayClient:
    """One CA-enrolled client: its own transport session plus per-service
    channels. ``call()`` is thread-safe but serial per client — open one
    client per concurrent caller (that's the session model).

    Resilience: every call carries an idempotency token; with ``retries``
    > 0 a call that fails with a *liveness* error (session crash/response
    timeout — never a security rejection) heals the transport session,
    re-keys the channel and resends the SAME token, so a retried request
    whose original did execute is answered from the gateway's dedup window
    instead of running twice."""

    def __init__(self, gw: ServiceGateway, name: str, *, retries: int = 0,
                 backoff: float = 0.005,
                 retry_budget: Optional["RetryBudget"] = None):
        self.gw = gw
        self.name = name
        self.retries = retries
        self.backoff = backoff
        # optional token bucket capping TOTAL extra attempts (liveness
        # retries here + fleet hedges downstream); share ONE instance
        # across clients to bound a whole tenant (docs/protocol.md §9)
        self.retry_budget = retry_budget
        self._kp, _ = enroll(gw.ca, name)
        self.cid = next(gw._cid_counter)
        # the transport session is created lazily on first wire use: a
        # client whose calls all ride the coalescing mux never opens its
        # own wire (at 256 fan-in callers that is 256 spared service
        # threads), yet keeps one for direct envelopes on demand
        self._session_obj: Optional[object] = None
        self._direct = False            # True: never route through the mux
        self._channels: Dict[str, Channel] = {}
        self._lock = threading.Lock()
        self._tokens = itertools.count(1)   # 0 = "no token" on the wire
        self.macs_verified = 0          # response MACs this client checked
        self.retried = 0                # liveness retries this client made

    @property
    def _session(self):
        s = self._session_obj
        if s is None:
            s = self._session_obj = self.gw.transport.connect(f"gw:{self.name}")
        return s

    @_session.setter
    def _session(self, s):
        self._session_obj = s

    def open(self, service: str) -> Channel:
        with self._lock:
            chan = self._channels.get(service)
            if chan is None:
                chan = self.gw._open_channel(self, service)
                self._channels[service] = chan
            return chan

    def reopen(self, service: str) -> Channel:
        """Drop the cached channel and open a fresh one (new key at the
        current epoch) — the recovery path after a domain-epoch bump."""
        with self._lock:
            self._channels.pop(service, None)
        return self.open(service)

    def heal(self, service: Optional[str] = None):
        """Recover from a dead/poisoned transport session: reconnect the
        session and (optionally) re-open the service channel so both sides
        restart from a fresh key + sequence 0."""
        s = self._session_obj
        if s is not None and (s._crashed or s._closed or s._poisoned):
            self._reconnect()
        if service is not None:
            self.reopen(service)

    def _reconnect(self):
        s = self._session_obj
        if s is not None:
            try:
                s.close()
            # mpklint: disable=MPK105 reason=best-effort close of a dead session during heal
            except Exception:
                pass
        self._session_obj = self.gw.transport.connect(f"gw:{self.name}")

    def _spend_retry(self) -> bool:
        """Charge the retry budget for one EXTRA attempt (True = granted).
        No budget installed = unlimited (the pre-budget behavior)."""
        return self.retry_budget is None or self.retry_budget.take()

    def _retry_sleep(self, attempts: int,
                     deadline: Optional[float]) -> None:
        delay = self.backoff * attempts
        if deadline is not None:
            delay = min(delay, max(0.0, deadline - time.monotonic()))
        if delay > 0:
            time.sleep(delay)

    def call(self, service: str, payload, *,
             token: Optional[int] = None,
             timeout: Optional[float] = None,
             priority: int = framing.PRIO_NORMAL) -> torch.Tensor:
        """One inline request/response. With coalescing enabled on the
        gateway (:meth:`ServiceGateway.enable_coalescing`), a plain call
        (``retries == 0``, no pinned token) is transparently folded into
        the mux's next cohort envelope — AFTER this client's own CA/ACL
        channel check, so per-client authorization is enforced exactly as
        on the direct path. ``token`` pins the idempotency token (a manual
        replay of an earlier call) and takes the direct path.

        ``timeout`` is the call's TOTAL budget: it spans every retry, is
        sealed into the envelope's MAC-covered deadline word, and rides
        hop-by-hop to the replica (docs/protocol.md §9) — an expired call
        sheds with a typed :class:`DeadlineExpired` wherever it happens to
        be, instead of burning a fixed per-hop transport timeout.

        ``priority`` (``framing.PRIO_HIGH`` / ``PRIO_NORMAL`` /
        ``PRIO_BULK``) is sealed into the frame's MAC-covered lane-12 word
        (docs/protocol.md §10): HIGH bypasses the coalescer wait window,
        BULK donates its latency budget to batch filling."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        if self.retry_budget is not None:
            self.retry_budget.note_primary()
        mux = self.gw._mux
        if (mux is not None and token is None
                and self.retries == 0
                and not self._direct and mux.accepts(service)):
            self.open(service)          # the CALLER's own CA/ACL gate
            # the cohort rides the CARRIER's cid on the wire, so the
            # tenant bucket must be charged HERE, against the true caller
            # — otherwise the mux would launder rate limits (§10)
            self.gw._admit_identity_name(self.name)
            return mux.call(service, payload, deadline=deadline,
                            priority=priority)
        if token is None:
            token = next(self._tokens) & 0xFFFFFFFF \
                or (next(self._tokens) & 0xFFFFFFFF)
        attempts = 0
        rekeys = 0
        while True:
            if deadline is not None and time.monotonic() >= deadline:
                raise DeadlineExpired(
                    f"call to {service!r}: deadline expired "
                    f"after {attempts} retr{'y' if attempts == 1 else 'ies'}")
            chan = self.open(service)
            try:
                return self._call_once(chan, payload, token,
                                       deadline=deadline, priority=priority)
            except AccessViolation as e:
                # someone's revocation (or a supervisor's release/join)
                # bumped the service-domain epoch; a still-certified
                # client just re-keys through the CA and retries — up to
                # REKEY_LIMIT times, because a supervisor healing
                # repeated kills bumps the epoch once per membership
                # change and a call can race several (a banned client
                # fails the certificate check in reopen()). No budget
                # charge: a re-key is recovery bookkeeping, not an extra
                # execution attempt
                if "stale key epoch" not in str(e) or rekeys >= REKEY_LIMIT:
                    raise
                rekeys += 1
                self.reopen(service)
            except DeadlineExpired:
                raise               # retrying expired work is pointless
            except Overloaded as e:
                attempts += 1
                if attempts > self.retries or not self._spend_retry():
                    raise
                self.retried += 1
                # honor the server's brownout hint, clamped to the budget
                delay = max(self.backoff * attempts, e.retry_after)
                if deadline is not None:
                    delay = min(delay,
                                max(0.0, deadline - time.monotonic()))
                if delay > 0:
                    time.sleep(delay)
            except ServiceUnavailable:
                attempts += 1
                if attempts > self.retries or not self._spend_retry():
                    raise
                self.retried += 1
                self._retry_sleep(attempts, deadline)
            except (ServiceCrashed, ResponseTimeout):
                attempts += 1
                if attempts > self.retries or not self._spend_retry():
                    raise
                self.retried += 1
                rekeyed = False
                self.heal(service)      # fresh session + channel, same token
                self._retry_sleep(attempts, deadline)

    def call_batch(self, service: str, payloads,
                   return_exceptions: bool = False) -> list:
        """Pipelined batch call: N messages in ONE gateway envelope / ONE
        transport round trip, sealed client-side and verified server-side
        in one vectorized MAC pass each. Returns responses in payload
        order; a failed message surfaces as its typed exception (in-place
        with ``return_exceptions``, else the first one is raised after the
        batch has drained). Batch calls carry no idempotency token and are
        not auto-retried — a liveness failure (crash/timeout) poisons the
        session as usual and ``heal()`` recovers; whole-batch security
        rejections advance neither side's sequence. Like ``call()``, a
        stale-key-epoch rejection (revocation / self-healing restart)
        re-keys through the CA transparently and retries once."""
        payloads = list(payloads)
        if not payloads:
            return []
        rekeyed = False
        while True:
            chan = self.open(service)
            try:
                return self._call_batch_once(chan, payloads,
                                             return_exceptions)
            except AccessViolation as e:
                # transparently re-key ONLY for pre-execution rejections:
                # a "post-execution" tag means the batch already ran under
                # the old epoch — resending it would double-execute
                if "stale key epoch" not in str(e) or rekeyed \
                        or "post-execution" in str(e):
                    raise
                rekeyed = True
                self.reopen(service)

    def mint_tokens(self, n: int) -> list:
        """``n`` fresh idempotency tokens — pass the SAME list back to
        :meth:`call_many` on a manual retry so already-executed items are
        answered from the dedup window instead of running twice."""
        with self._lock:
            # both draws masked: an unmasked wraparound fallback would
            # truncate on the u32 wire word to a possibly-live token
            return [next(self._tokens) & 0xFFFFFFFF
                    or (next(self._tokens) & 0xFFFFFFFF)
                    for _ in range(n)]

    @_on_transport_stream
    def call_many(self, items, return_exceptions: bool = False,
                  tokens=None, deadlines=None, priorities=None) -> list:
        """Scatter call: N (service, payload) pairs in ONE envelope / ONE
        transport round trip, executed across the gateway's worker shards —
        with ``workers=N`` the items' handlers run concurrently per
        service, so a slow service no longer head-of-line blocks the rest
        of the scatter. Returns responses in item order; a failed item
        surfaces as its typed exception (in place with
        ``return_exceptions``, else the first one is raised after the
        scatter has drained). Every item consumes a sequence number on its
        channel, success or failure — batch discipline. Scatter calls are
        NOT auto-retried; to make a manual retry idempotent, pre-mint
        tokens (:meth:`mint_tokens`) and pass the same ``tokens`` list to
        every attempt — items whose original executed are then answered
        from the gateway's dedup window, never re-executed. A stale-epoch
        rejection surfaces per item; recovery is ``reopen(service)`` +
        reissue.

        ``deadlines`` (positional, absolute ``time.monotonic()`` values or
        ``None``) seals each item's remaining budget into its frame's
        MAC-covered deadline word; the WIRE round trip is bounded by the
        cohort's tightest member (docs/protocol.md §9). ``priorities``
        (positional lane-12 classes, default ``PRIO_NORMAL``) seals each
        item's priority into its frame (docs/protocol.md §10).

        The envelope is staged straight into the transport (the request
        region on mpklink): route words, then each channel's frames sealed
        in place with one ``mac_batch`` pass per channel group."""
        items = [(s, _payload(p)) for s, p in items]
        if not items:
            return []
        if tokens is not None and len(tokens) != len(items):
            raise ValueError(f"{len(tokens)} tokens for {len(items)} items")
        if deadlines is not None and len(deadlines) != len(items):
            raise ValueError(
                f"{len(deadlines)} deadlines for {len(items)} items")
        if priorities is None:
            priorities = [framing.PRIO_NORMAL] * len(items)
        elif len(priorities) != len(items):
            raise ValueError(
                f"{len(priorities)} priorities for {len(items)} items")
        timeout: Optional[float] = None
        dl_us = [0] * len(items)
        if deadlines is not None:
            now = time.monotonic()
            rems = [None if d is None else d - now for d in deadlines]
            live = [r for r in rems if r is not None]
            if live:
                timeout = max(min(live), 0.001)
            dl_us = [0 if r is None else framing.deadline_to_us(r)
                     for r in rems]
        for service, _ in items:            # channel setup (CA-checked)
            self.open(service)
        if tokens is None:
            tokens = self.mint_tokens(len(items))
        with self._lock:
            chans = {s: self._channels[s] for s, _ in items}
            counts: Dict[str, int] = {}
            seqs = []
            for service, _ in items:
                k = counts.get(service, 0)
                seqs.append((chans[service].seq + k) & 0xFFFFFFFF)
                counts[service] = k + 1
            if framing.ZERO_COPY:
                rows_list = [framing.frame_rows(_frame_nbytes(p))
                             for _, p in items]
                total = _ROUTE_BYTES + sum(
                    _ROUTE_BYTES + r * framing.LANES * 4 for r in rows_list)

                def fill(dst, items=items, seqs=seqs, tokens=tokens,
                         rows_list=rows_list, chans=chans, dl_us=dl_us,
                         priorities=priorities):
                    words = dict(zip((0, 4, 8, 12), _scatter_route(
                        self.cid, len(items)).view("<u4").tolist()))
                    ofs = _ROUTE_BYTES
                    groups: Dict[str, list] = {}
                    for (service, p), seq, token, rows, du, pr in zip(
                            items, seqs, tokens, rows_list, dl_us, priorities):
                        chan = chans[service]
                        words.update({ofs: GW_MAGIC, ofs + 4: chan.sid,
                                      ofs + 8: token, ofs + 12: 0})
                        body = ofs + _ROUTE_BYTES
                        buf = dst[body: body + rows * framing.LANES * 4] \
                            .view(torch.uint32).reshape(rows, framing.LANES)
                        groups.setdefault(service, []).append(
                            (buf, p, seq, du, pr))
                        ofs = body + rows * framing.LANES * 4
                    _write_words(dst, words)
                    for service, members in groups.items():
                        framing.seal_into_batch(
                            [b for b, _, _, _, _ in members],
                            [p for _, p, _, _, _ in members],
                            seed=chans[service].seed,
                            seqs=[q for _, _, q, _, _ in members],
                            deadlines_us=[d for _, _, _, d, _ in members],
                            priorities=[r for _, _, _, _, r in members])

                # mpklint: disable=MPK002 reason=client lock IS the per-session serializer (spec: sessions are serial per client)
                raw = self._session.request_into(total, fill, timeout=timeout)
            else:
                # the legacy copy plane: each frame built apart, then joined
                parts = [_scatter_route(self.cid, len(items))]
                for (service, p), seq, token, du, pr in zip(
                        items, seqs, tokens, dl_us, priorities):
                    chan = chans[service]
                    parts.append(np.array([GW_MAGIC, chan.sid, token, 0], "<u4")
                                 .view(np.uint8))
                    parts.append(framing.build_frame(
                        p, seed=chan.seed, seq=seq, deadline_us=du, priority=pr,
                        device=self.gw.device))
                # mpklint: disable=MPK002 reason=client lock IS the per-session serializer (spec: sessions are serial per client)
                raw = self._session.request(_join(parts, self.gw.device),
                                            timeout=timeout)
            hb = _HostBytes(raw)
            route = _response_route(hb)
            if route[1] == _ERR:            # whole-envelope failure: no item
                _raise_remote(hb.get(_ROUTE_BYTES, route[3]).tobytes())
            if route[1] != _SOK or route[3] != len(items):
                raise TransportError("malformed gateway scatter response")
            results: list = [None] * len(items)
            ok_by_svc: Dict[str, list] = {}     # service → (i, frame, hdr, seq)
            for i, ((service, _), seq, (status, body)) in enumerate(zip(
                    items, seqs, _read_items(hb, len(items), "scatter"))):
                if status == _OK:
                    ok_by_svc.setdefault(service, []).append(
                        (i, body[0], body[1], seq))
                else:
                    try:
                        _raise_remote(body)
                    except Exception as e:
                        results[i] = e
            # ONE batched verify pass per channel; a corrupted item becomes
            # ITS typed FrameError (strict=False) — the rest of the scatter
            # drains and the sequence advance below keeps every channel
            # aligned with the server's positional discipline
            for service, members in ok_by_svc.items():
                verified = framing.verify_batch(
                    [f for _, f, _, _ in members], seed=chans[service].seed,
                    seqs=[q for _, _, _, q in members], strict=False,
                    headers=[h for _, _, h, _ in members])
                for (i, _, _, _), v in zip(members, verified):
                    results[i] = _own_result(v)
                    if not isinstance(v, framing.FrameError):
                        self.macs_verified += 1
            for service, k in counts.items():   # every item consumed a seq
                chans[service].seq += k
        if not return_exceptions:
            for r in results:
                if isinstance(r, BaseException):
                    raise r
        return results

    @_on_transport_stream
    def _call_batch_once(self, chan: Channel, payloads,
                         return_exceptions: bool) -> list:
        with self._lock:
            n = len(payloads)
            # the whole batch envelope is staged straight into the
            # transport (the request region on mpklink): route words + N
            # frames sealed in place with ONE batched MAC pass
            ps = [_payload(p) for p in payloads]
            if framing.ZERO_COPY:
                rows_list = [framing.frame_rows(_frame_nbytes(p)) for p in ps]
                env_nbytes = _ROUTE_BYTES + sum(
                    r * framing.LANES * 4 for r in rows_list)

                def fill(dst, ps=ps, rows_list=rows_list, chan=chan):
                    dst[:_ROUTE_BYTES].copy_(torch.from_numpy(
                        _batch_route(chan.sid, self.cid, n)))
                    bufs, ofs = [], _ROUTE_BYTES
                    for r in rows_list:
                        bufs.append(dst[ofs: ofs + r * framing.LANES * 4]
                                    .view(torch.uint32).reshape(r, framing.LANES))
                        ofs += r * framing.LANES * 4
                    framing.seal_into_batch(
                        bufs, ps, seed=chan.seed,
                        seqs=[chan.seq + i for i in range(n)])

                # mpklint: disable=MPK002 reason=client lock IS the per-session serializer (spec: sessions are serial per client)
                raw = self._session.request_into(env_nbytes, fill)
            else:
                # the legacy copy plane: the frames sealed apart, then joined
                frames = framing.seal_batch_legacy(
                    ps, seed=chan.seed, seqs=[chan.seq + i for i in range(n)],
                    device=self.gw.device)
                env = _join([_batch_route(chan.sid, self.cid, n)] + frames,
                            self.gw.device)
                # mpklint: disable=MPK002 reason=client lock IS the per-session serializer (spec: sessions are serial per client)
                raw = self._session.request(env)
            hb = _HostBytes(raw)
            route = _response_route(hb)
            if route[1] == _ERR:            # whole-batch failure: no item
                _raise_remote(hb.get(_ROUTE_BYTES, route[3]).tobytes())
            if route[1] != _BOK or route[3] != n:
                raise TransportError("malformed gateway batch response")
            start = chan.seq
            results: list = [None] * n
            ok_frames, ok_headers, ok_pos = [], [], []
            for i, (status, body) in enumerate(_read_items(hb, n, "batch")):
                if status == _OK:
                    ok_frames.append(body[0])
                    ok_headers.append(body[1])
                    ok_pos.append(i)
                else:
                    try:
                        _raise_remote(body)
                    except Exception as e:
                        results[i] = e
            if ok_frames:                   # ONE batched verify pass
                verified = framing.verify_batch(
                    ok_frames, seed=chan.seed,
                    seqs=[start + i for i in ok_pos], strict=False,
                    headers=ok_headers)
                for p, v in zip(ok_pos, verified):
                    results[p] = _own_result(v)
                    if not isinstance(v, framing.FrameError):
                        self.macs_verified += 1
            chan.seq += n                   # every item consumed a sequence
        if not return_exceptions:
            for r in results:
                if isinstance(r, BaseException):
                    raise r
        return results

    @_on_transport_stream
    def _call_once(self, chan: Channel, payload,
                   token: int = 0,
                   deadline: Optional[float] = None,
                   priority: int = framing.PRIO_NORMAL) -> torch.Tensor:
        # the remaining budget (not a fresh constant) bounds this attempt's
        # wire timeout and is sealed into the envelope's deadline word —
        # the hop-by-hop propagation contract (docs/protocol.md §9). The
        # wire wait stays clamped to the transport's per-attempt bound so
        # a lost response costs ONE attempt's wait, not the whole budget
        # (the remaining retries still get their share)
        timeout: Optional[float] = None
        deadline_us = 0
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise DeadlineExpired(
                    f"call on channel {chan.service!r}: deadline expired "
                    "before send")
            deadline_us = framing.deadline_to_us(remaining)
            timeout = min(remaining, self.gw.transport.timeout)
        with self._lock:
            # fully in-place send: route words + the sealed gateway frame
            # are written straight into the transport's staging storage
            # (the request region on mpklink)
            p = _payload(payload)
            frows = framing.frame_rows(_frame_nbytes(p))
            env_nbytes = _ROUTE_BYTES + frows * framing.LANES * 4

            def fill(dst, p=p, frows=frows, chan=chan, token=token,
                     deadline_us=deadline_us, priority=priority):
                dst[:_ROUTE_BYTES].copy_(torch.from_numpy(np.array(
                    [GW_MAGIC, chan.sid, self.cid, token], "<u4")
                    .view(np.uint8)))
                framing.seal_into(
                    dst[_ROUTE_BYTES:].view(torch.uint32)
                    .reshape(frows, framing.LANES), p,
                    seed=chan.seed, seq=chan.seq,
                    deadline_us=deadline_us, priority=priority)

            try:
                if framing.ZERO_COPY:
                    # mpklint: disable=MPK002 reason=client lock IS the per-session serializer (spec: sessions are serial per client)
                    raw = self._session.request_into(env_nbytes, fill,
                                                     timeout=timeout)
                else:                   # the legacy copy plane's envelope
                    env = _seal_envelope(
                        [GW_MAGIC, chan.sid, self.cid, token], p,
                        seed=chan.seed, seq=chan.seq, device=self.gw.device,
                        deadline_us=deadline_us, priority=priority)
                    # mpklint: disable=MPK002 reason=client lock IS the per-session serializer (spec: sessions are serial per client)
                    raw = self._session.request(env, timeout=timeout)
            except ResponseTimeout as e:
                # a wire wait cut short by the call's own budget is the
                # budget running out, wherever the request got to: typed
                # DeadlineExpired (the session is poisoned all the same)
                if deadline is None or isinstance(e, DeadlineExpired) \
                        or time.monotonic() < deadline:
                    raise
                raise DeadlineExpired(
                    f"call on channel {chan.service!r}: deadline expired "
                    f"while waiting for the response ({e})") from None
            # the route words and the response frame's header: one copy
            hb = _HostBytes(raw, _HEAD_BYTES)
            route = _response_route(hb)
            if route[1] != _OK:
                _raise_remote(hb.get(_ROUTE_BYTES, route[3]).tobytes())
            nb = raw.numel() - _ROUTE_BYTES
            if nb <= 0 or nb % (framing.LANES * 4):
                raise TransportError(
                    "malformed gateway response (not lane-aligned)")
            rframe = raw[_ROUTE_BYTES:].view(torch.uint32) \
                .reshape(-1, framing.LANES)
            out = framing.parse_frame(rframe, seed=chan.seed,
                                      expect_seq=chan.seq,
                                      header=hb.words(_ROUTE_BYTES,
                                                      framing.LANES))
            chan.seq += 1
            self.macs_verified += 1
            return _own_result(out)

    def close(self):
        self.gw._release_client(self)
        with self._lock:
            self._channels.clear()
        if self._session_obj is not None:
            self._session_obj.close()


# ---------------------------------------------------------------------------
# transparent call coalescing (the auto-batching mux)
# ---------------------------------------------------------------------------

class _PendingCall:
    """One caller's parked inline call while it rides a cohort."""

    __slots__ = ("service", "payload", "token", "deadline", "priority",
                 "event", "result", "error")

    def __init__(self, service: str, payload: torch.Tensor, token: int,
                 deadline: Optional[float] = None,
                 priority: int = framing.PRIO_NORMAL):
        self.service = service
        self.payload = payload
        self.token = token
        self.deadline = deadline        # absolute monotonic, None = no budget
        self.priority = priority        # lane-12 class (protocol.md §10)
        self.event = threading.Event()
        self.result: Optional[torch.Tensor] = None
        self.error: Optional[BaseException] = None


class CallCoalescer:
    """Transparent auto-batching for inline gateway calls.

    64 independent clients issuing inline ``call()``s pay one transport
    round trip (key syncs + doorbell wakeups + scalar MAC) EACH. The mux
    removes that per-message constant without asking callers to change:
    concurrent calls arriving within an **adaptive window** are folded
    into ONE scatter envelope (``GW_SCAT_MAGIC``) on a dedicated carrier
    client — one round trip, one fused MAC pass per channel group on each
    side, one wakeup per cohort — and the per-item responses are handed
    back to their callers. A single-service cohort degenerates server-side
    to the batch pipeline (one channel group: one fused verify, ONE native
    ``batch_handler`` call when the service registered one — an
    EngineService cohort joins the decode grid as one unit, one fused
    seal).

    Semantics are the inline ones, preserved bit-for-bit:

    * **ordering** — a caller is serial (it blocks for its result), and a
      channel group executes in envelope order, so per-caller order holds;
    * **authorization** — ``GatewayClient.call`` opens the CALLER's own
      channel (CA + allow-list check) before folding; services that refuse
      the carrier identity simply keep the direct path (:meth:`accepts`);
    * **idempotency/dedup** — every folded call carries a carrier-minted
      token; the liveness fallback replays the SAME tokens inline, so an
      item whose cohort envelope executed but whose response was lost is
      answered from the gateway dedup window, never re-executed;
    * **breaker** — items execute under the same ``_run_guarded`` /
      admission core; a shed surfaces as that item's typed
      ``ServiceUnavailable``;
    * **crash** — a cohort envelope that dies on the wire surfaces per
      item: the mux heals the carrier session and replays each item inline
      (same token), so a poisoned item fails typed while its cohort-mates
      recover; a stale-epoch rejection re-keys through the CA and retries
      once, exactly like ``call()``.

    Adaptive window: the drainer waits
    ``min(max_wait_us, (max_batch - 1) * EWMA(inter-arrival gap))`` for a
    cohort to fill — long enough to collect ~``max_batch`` arrivals at the
    observed rate — and waits nothing at all when arrivals are sparser
    than ``max_wait_us`` apart (coalescing cannot pay there; latency is
    not taxed). The window is recomputed per cohort, so the mux tracks
    load swings. The normative rules live in docs/protocol.md §5.4.
    """

    def __init__(self, gw: ServiceGateway, *, max_batch: int = 64,
                 max_wait_us: float = 300.0, name: str = "gw:coalescer",
                 ewma_alpha: float = 0.2):
        if max_batch < 1 or max_batch > _MAX_SCATTER:
            raise ValueError(f"max_batch must be in [1, {_MAX_SCATTER}]")
        self.gw = gw
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self._alpha = float(ewma_alpha)
        # retries=2: the liveness-fallback replays ride the carrier's own
        # bounded retry (same pinned token each attempt → dedup-protected),
        # so a fault landing on a REPLAY heals too instead of surfacing
        self._carrier = gw.connect(name, retries=2)
        self._carrier._direct = True        # the carrier never re-enters
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: List[_PendingCall] = []
        self._ewma_gap: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._accepted: set = set()         # services the carrier may fold
        self._refused: set = set()          # services that refuse the carrier
        self._stop = threading.Event()
        self.stats: Dict[str, int] = {
            "cohorts": 0, "coalesced_calls": 0, "max_cohort": 0,
            "fallback_items": 0, "rekeys": 0}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gw-coalescer")
        self._thread.start()

    # -- caller side --------------------------------------------------------
    def accepts(self, service: str) -> bool:
        """True when calls to ``service`` can ride the mux — i.e. the
        carrier identity is authorized for it. Checked against the CA once
        and cached BOTH ways: the positive path must not touch the carrier
        (whose lock is held across a cohort's whole wire round trip — an
        uncached probe would serialize arriving callers behind the
        in-flight cohort instead of letting the next cohort form)."""
        if self._stop.is_set():
            return False
        if service in self._accepted:
            return True
        if service in self._refused:
            return False
        try:
            self._carrier.open(service)
            self._accepted.add(service)
            return True
        except AccessViolation:
            self._refused.add(service)
            return False

    def call(self, service: str, payload: torch.Tensor,
             deadline: Optional[float] = None,
             priority: int = framing.PRIO_NORMAL) -> torch.Tensor:
        """Fold one inline call into the next cohort; block for ITS result
        (or raise its typed error). The caller's wait bound DERIVES from
        its propagated deadline when it has one — remaining budget, plus
        one wire attempt for the cohort that may already be in flight,
        plus the batching window and fixed slack — so a 1 s-deadline call
        fails typed in about a second. Without a deadline the bound is
        two transport attempts (the cohort's wire trip + the liveness
        fallback's shared replay budget) plus window and slack: every
        term is a budget some layer actually spends, no bare constants
        (docs/protocol.md §9). ``priority`` steers the batching window
        (§10): a PRIO_HIGH arrival collapses the wait to zero — the cohort
        dispatches with whatever has gathered — while an all-PRIO_BULK
        cohort always waits the full ``max_wait_us`` to fill."""
        if self._stop.is_set():
            raise TransportError("coalescer is closed")
        entry = _PendingCall(service, payload,
                             self._carrier.mint_tokens(1)[0], deadline,
                             priority)
        with self._cond:
            # re-check under the lock: close() sets _stop under it too, so
            # an entry can never slip in after close() drained the queue
            # (it would otherwise strand until the full event-wait bound)
            if self._stop.is_set():
                raise TransportError("coalescer is closed")
            now = time.monotonic()
            if self._last_arrival is not None:
                gap = now - self._last_arrival
                self._ewma_gap = gap if self._ewma_gap is None else \
                    (1.0 - self._alpha) * self._ewma_gap + self._alpha * gap
            self._last_arrival = now
            self._pending.append(entry)
            self._cond.notify_all()
        window_slack = self.max_wait_us / 1e6 + 1.0
        if deadline is not None:
            bound = max(0.0, deadline - time.monotonic()) \
                + self.gw.transport.timeout + window_slack
        else:
            bound = self.gw.transport.timeout * 2 + window_slack
        if not entry.event.wait(bound):
            raise ResponseTimeout(
                f"coalesced call to {service!r} stalled past the transport "
                f"deadline")
        if entry.error is not None:
            raise entry.error
        return entry.result

    def _window_s(self) -> float:
        cap = self.max_wait_us / 1e6
        gap = self._ewma_gap
        if gap is None:
            return cap
        if gap >= cap:                  # arrivals sparser than the window:
            return 0.0                  # coalescing can't pay — don't wait
        return min(cap, gap * (self.max_batch - 1))

    def _priority_window_s(self) -> float:
        """The batching window under the cohort's priority mix
        (docs/protocol.md §10). Called under the condition lock.

        * any PRIO_HIGH pending → 0 — a latency-sensitive call never
          donates its budget to batch filling; the cohort goes now;
        * all PRIO_BULK → the full ``max_wait_us`` cap — throughput
          traffic always waits out the window so cohorts fill;
        * mixed/normal → the adaptive EWMA window (§5.4), unchanged.
        """
        ranks = [priority_rank(e.priority) for e in self._pending]
        if min(ranks) == _PRIO_RANK[framing.PRIO_HIGH]:
            return 0.0
        if max(ranks) == min(ranks) == _PRIO_RANK[framing.PRIO_BULK]:
            return self.max_wait_us / 1e6
        return self._window_s()

    def _has_high(self) -> bool:
        return any(priority_rank(e.priority)
                   == _PRIO_RANK[framing.PRIO_HIGH] for e in self._pending)

    # -- drainer ------------------------------------------------------------
    def _run(self):
        while True:
            with self._cond:
                while not self._pending:
                    if self._stop.is_set():
                        return
                    self._cond.wait(0.5)
                deadline = time.monotonic() + self._priority_window_s()
                while (len(self._pending) < self.max_batch
                       and not self._stop.is_set()):
                    if self._has_high():
                        break           # a HIGH arrival ends the window NOW
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                if len(self._pending) > self.max_batch:
                    # overflow cohort: urgent classes board first, arrival
                    # order preserved within a class (stable selection);
                    # the bumped tail keeps its relative order for the
                    # next cohort
                    take = sorted(sorted(
                        range(len(self._pending)),
                        key=lambda i: (priority_rank(
                            self._pending[i].priority), i))
                        [: self.max_batch])
                    batch = [self._pending[i] for i in take]
                    for i in reversed(take):
                        del self._pending[i]
                else:
                    batch = self._pending[:]
                    self._pending.clear()
            try:
                self._execute(batch)
            except BaseException as e:  # noqa: B036 — never strand a caller
                for entry in batch:
                    if not entry.event.is_set():
                        if entry.error is None and entry.result is None:
                            entry.error = TransportError(
                                f"coalescer dispatch failed: "
                                f"{type(e).__name__}: {e}")
                        entry.event.set()

    # the carrier already hands back owned results (_own_result at the
    # GatewayClient boundary); kept as a second line of defense so a mux
    # result can never alias storage the next cohort's exchange recycles
    _own = staticmethod(_own_result)

    def _execute(self, batch: List[_PendingCall]):
        self.stats["cohorts"] += 1
        self.stats["coalesced_calls"] += len(batch)
        self.stats["max_cohort"] = max(self.stats["max_cohort"], len(batch))
        items = [(e.service, e.payload) for e in batch]
        tokens = [e.token for e in batch]
        deadlines = [e.deadline for e in batch]
        priorities = [e.priority for e in batch]
        rekeyed = False
        while True:
            try:
                results = [self._own(r) for r in self._carrier.call_many(
                    items, return_exceptions=True, tokens=tokens,
                    deadlines=deadlines, priorities=priorities)]
                break
            except AccessViolation as e:
                # pre-dispatch stale epoch (carrier channel open): re-key
                # through the CA once and resend — the envelope never ran
                if "stale key epoch" not in str(e) or rekeyed:
                    results = [e] * len(batch)
                    break
                rekeyed = True
                self.stats["rekeys"] += 1
                for svc in dict.fromkeys(e2.service for e2 in batch):
                    self._carrier.reopen(svc)
            except (ServiceCrashed, ResponseTimeout, TransportError):
                # the WHOLE envelope died on the wire. Heal the carrier and
                # replay every item inline with its ORIGINAL token: items
                # the envelope did execute are answered from the gateway
                # dedup window (never re-executed); the rest run fresh —
                # per-item inline semantics, bit-for-bit
                results = self._fallback(batch)
                break
        for entry, res in zip(batch, results):
            if isinstance(res, AccessViolation) \
                    and "stale key epoch" in str(res):
                # per-item stale epoch (revocation landed mid-cohort):
                # transparent re-key + single inline retry, like call()
                try:
                    self._carrier.reopen(entry.service)
                    res = self._own(self._carrier.call(
                        entry.service, entry.payload, token=entry.token,
                        priority=entry.priority))
                    self.stats["rekeys"] += 1
                except Exception as e2:
                    res = e2
            if isinstance(res, BaseException):
                entry.error = res
            else:
                entry.result = res
            entry.event.set()

    def _fallback(self, batch: List[_PendingCall]) -> list:
        """Replay a failed cohort inline, item by item, with the ORIGINAL
        tokens. The whole pass shares ONE transport-deadline budget: each
        item gets the remaining budget split over the items left, so a
        wedged service costs its items their (shrinking) share instead of
        head-of-line blocking every coalesced caller in the process for
        items x retries x timeout. An item that carries its own propagated
        deadline is bounded by the TIGHTER of the two — and one already
        expired is failed typed immediately, before any cohort-mate's
        replay can sit on it."""
        self.stats["fallback_items"] += len(batch)
        deadline = time.monotonic() + self.gw.transport.timeout
        healed: set = set()                 # services reopened this session
        out = []
        for k, entry in enumerate(batch):
            per_item = max(0.05,
                           (deadline - time.monotonic()) / (len(batch) - k))
            if entry.deadline is not None:
                remaining = entry.deadline - time.monotonic()
                if remaining <= 0:
                    out.append(DeadlineExpired(
                        f"coalesced call to {entry.service!r}: deadline "
                        "expired during the cohort's liveness fallback"))
                    continue
                per_item = min(per_item, remaining)
            try:
                s = self._carrier._session_obj
                if s is None or s._crashed or s._closed or s._poisoned:
                    self._carrier.heal()    # fresh session; channels stale
                    healed.clear()
                if entry.service not in healed:
                    self._carrier.reopen(entry.service)     # seqs reset
                    healed.add(entry.service)
                # budget per_item PER ATTEMPT: a replay that is itself
                # dropped must still afford the carrier's bounded retries
                # (wire waits stay clamped per attempt in _call_once)
                out.append(self._own(self._carrier.call(
                    entry.service, entry.payload, token=entry.token,
                    timeout=per_item * (self._carrier.retries + 1),
                    priority=entry.priority)))
            except Exception as e:          # noqa: PERF203 — per-item fate
                out.append(e)
        return out

    def close(self):
        """Stop the drainer, fail anything still parked (typed), release
        the carrier. Idempotent."""
        if self._stop.is_set():
            return
        with self._cond:                    # atomic with call()'s re-check
            self._stop.set()
            self._cond.notify_all()
        self._thread.join(timeout=10)
        with self._cond:
            doomed, self._pending = self._pending, []
        for entry in doomed:
            entry.error = TransportError(
                "coalescer closed while the call was in flight")
            entry.event.set()
        try:
            self._carrier.close()
        # mpklint: disable=MPK105 reason=best-effort carrier close at shutdown
        except Exception:
            pass


# ---------------------------------------------------------------------------
# replica fleets (the replicated serving layer)
# ---------------------------------------------------------------------------

EWMA_ALPHA = 0.2                    # replica service-time EWMA smoothing


class _ReplicaGone(Exception):
    """Internal routing signal: the picked replica died between admission
    and wire submission. The request was NEVER sent, so it is safe to
    re-route to a survivor — unlike a true in-flight loss, which must
    surface as the typed ServiceCrashed. Never escapes the fleet."""


class ReplicaRouter:
    """Seeded power-of-two-choices least-loaded router.

    Per decision the router draws exactly ``choices`` distinct candidate
    indices from its private seeded stream and picks the least-loaded by
    ``(inflight, ewma_ms, rid)``. Everything is deterministic in (seed,
    observation sequence): two routers built from the same seed and fed
    the same load observations produce the identical assignment sequence
    — the FaultPlan property that makes fleet bugs reproduce from a
    one-line seed. With ``record=True`` every decision is appended to
    ``trace`` as ``(loads, candidates, picked)`` and :meth:`replay`
    re-derives the picks from a fresh router, failing loudly on the first
    divergence."""

    def __init__(self, seed: int = 0x524F5554, *,
                 choices: int = FLEET_CHOICES, record: bool = False):
        if choices < 1:
            raise ValueError("choices must be >= 1")
        self.seed = seed
        self.choices = choices
        self.record = record
        self._rng = random.Random(seed)
        self.picks = 0
        self.assigned: Dict[int, int] = {}      # rid -> decisions won
        self.trace: List[Tuple] = []            # (loads, cands, picked)

    def pick(self, loads) -> int:
        """One routing decision. ``loads`` is the ordered ACTIVE set as
        ``(rid, inflight, ewma_ms)`` triples; → the picked rid."""
        n = len(loads)
        if n == 0:
            raise ServiceUnavailable("router invoked with no active replicas")
        cands = [loads[i] for i in self._draw(n)]
        picked = min(cands, key=lambda t: (t[1], t[2], t[0]))[0]
        self.picks += 1
        self.assigned[picked] = self.assigned.get(picked, 0) + 1
        if self.record:
            self.trace.append((tuple(loads),
                               tuple(c[0] for c in cands), picked))
        return picked

    def _draw(self, n: int) -> List[int]:
        """``min(choices, n)`` distinct indices. The draw count depends
        only on ``n`` (part of every observation), keeping the stream
        position — and therefore every later decision — deterministic."""
        k = min(self.choices, n)
        out: List[int] = []
        for d in range(k):
            j = self._rng.randrange(n - d)
            for prev in sorted(out):
                if j >= prev:
                    j += 1
            out.append(j)
        return out

    def replay(self, trace) -> List[int]:
        """Re-derive a recorded decision sequence from a FRESH router with
        this router's seed/choices; raises AssertionError on the first
        divergent pick. → the replayed assignment sequence."""
        fresh = ReplicaRouter(self.seed, choices=self.choices)
        out = []
        for k, (loads, _cands, picked) in enumerate(trace):
            got = fresh.pick(list(loads))
            if got != picked:
                raise AssertionError(
                    f"router replay diverged at decision {k}: "
                    f"recorded rid {picked}, replayed rid {got} "
                    f"(seed {self.seed:#x})")
            out.append(got)
        return out


def simulate_assignments(seed: int, arrivals_ms, n_replicas: int,
                         service_ms=1.0, *,
                         choices: int = FLEET_CHOICES) -> List[int]:
    """Deterministic discrete-event model of fleet routing: each replica
    serves serially at ``service_ms`` per item (scalar or per-arrival
    sequence); inflight at each arrival instant is derived from completion
    times, never from wall clock. Pure function of its arguments —
    identical ``(seed, arrival trace)`` yields the identical replica
    assignment sequence, which is both the determinism property the tests
    pin and the offline tool for reproducing a fleet imbalance from a
    one-line seed."""
    router = ReplicaRouter(seed, choices=choices)
    svc = list(service_ms) if np.ndim(service_ms) else \
        [float(service_ms)] * len(list(arrivals_ms))
    arrivals = list(arrivals_ms)
    if len(svc) != len(arrivals):
        raise ValueError(f"{len(svc)} service times for "
                         f"{len(arrivals)} arrivals")
    outstanding: List[List[float]] = [[] for _ in range(n_replicas)]
    finish = [0.0] * n_replicas
    ewma = [0.0] * n_replicas
    out: List[int] = []
    for t, s in zip(arrivals, svc):
        loads = []
        for rid in range(n_replicas):
            outstanding[rid] = [c for c in outstanding[rid] if c > t]
            loads.append((rid, len(outstanding[rid]), ewma[rid]))
        picked = router.pick(loads)
        done = max(t, finish[picked]) + s
        finish[picked] = done
        outstanding[picked].append(done)
        ewma[picked] = s if ewma[picked] == 0.0 else \
            (1.0 - EWMA_ALPHA) * ewma[picked] + EWMA_ALPHA * s
        out.append(picked)
    return out


class Replica:
    """One fleet member: its own transport instance (its own key registry,
    protection domain and epoch — proc-backed by default, so the handler
    runs in a child process over a private POSIX shm segment) plus the one
    session the fleet drives it through. The session is serial per the
    session model; ``rlock`` is the fleet-side serializer. ``inflight``
    counts admission→completion (queued + on the wire), which is what the
    power-of-two router balances on."""

    def __init__(self, rid: int, service: str, transport, session):
        self.rid = rid
        self.service = service
        self.transport = transport
        self.session = session
        self.state = REPLICA_ACTIVE
        self.inflight = 0
        self.ewma_ms: Optional[float] = None
        self.served = 0
        self.crashes = 0
        self.released = False
        self.rlock = threading.Lock()       # serializes wire use
        self.quiesced = threading.Event()


class ServiceFleet:
    """N replicas behind one service name, with routing, cohort-whole
    admission, drain/join and crash containment (docs/protocol.md §8,
    docs/architecture.md "The replica fleet").

    * ``dispatch`` is the service handler: seeded power-of-two-choices
      least-loaded admission, then one ``session.request`` on the picked
      replica. A replica that dies between admission and submission is
      re-routed (the request never reached a wire); a true in-flight death
      surfaces as the typed :class:`ServiceCrashed` and marks the replica
      DEAD — the router never picks it again.
    * ``dispatch_batch`` is the service ``batch_handler``: a batch
      envelope or auto-coalesced cohort lands WHOLE on one replica and
      rides its ring as one pipelined ``call_batch`` (cohort-aware
      admission — a cohort is never split across replicas).
    * ``drain``/``add`` implement the live-traffic membership machinery;
      both epoch-bump the service domain through the gateway so clients
      re-key exactly once per membership change.
    """

    def __init__(self, gw: "ServiceGateway", name: str, *,
                 router_seed: int = 0x524F5554):
        self.gw = gw
        self.name = name
        self.router = ReplicaRouter(router_seed)
        self._lock = threading.Lock()
        self._replicas: "OrderedDict[int, Replica]" = OrderedDict()
        self._rid_counter = itertools.count(0)
        # last add()'s (handler, transport, kwargs): what a supervisor
        # respawns a dead replica FROM (docs/protocol.md §9)
        self._spawn: Optional[tuple] = None
        # hedging (enable_hedging): OFF by default
        self._hedge = False
        self._hedge_delay: Optional[float] = None
        self._hedge_quantile = 0.95
        self.hedge_budget: Optional[RetryBudget] = None
        self._lat_ms: "deque" = deque(maxlen=HEDGE_RESERVOIR)
        # per-tenant WFQ over replica in-flight slots (enable_fair_queue):
        # OFF by default
        self._fair_gate: Optional[_FairGate] = None
        self.stats = {"routed": 0, "cohorts": 0, "rerouted": 0,
                      "crashes": 0, "drains": 0, "joins": 0,
                      "expired": 0, "hedges_fired": 0, "hedges_won": 0,
                      "fair_queued": 0}

    # -- membership ---------------------------------------------------------
    def add(self, handler: Handler, *,
            transport: Union[str, type] = "mpklink_opt_proc",
            transport_kwargs: Optional[dict] = None) -> int:
        """Start one replica of ``handler`` behind its own transport
        instance and place it in the routing set. → replica id.

        A join resets every member's service-time EWMA to unobserved, so
        the router samples each member of the new set before it compares
        latencies. Without it the router compares the newcomer's fresh
        samples with EWMAs that stopped moving when their replicas stopped
        being picked: one slow sample of an old replica kept it out of the
        routing set for good (the reference shares the rule; its faster,
        steadier exchanges rarely show it)."""
        transport = _transport_class(transport)
        kwargs = dict(transport_kwargs or {})
        kwargs.setdefault("device", self.gw.device)
        self._spawn = (handler, transport, kwargs)
        tr = transport(handler, **kwargs)
        try:
            with self._lock:
                rid = next(self._rid_counter)
                session = tr.connect(f"replica:{self.name}#{rid}")
                for rep in self._replicas.values():
                    rep.ewma_ms = None
                self._replicas[rid] = Replica(rid, self.name, tr, session)
                self.stats["joins"] += 1
        except BaseException:
            tr.close()
            raise
        return rid

    def drain(self, rid: int, timeout: Optional[float] = 30.0) -> bool:
        """ACTIVE → DRAINING immediately (the router stops picking it; new
        admissions are impossible), then wait up to ``timeout`` for the
        admitted in-flight work to complete. Quiescence releases the
        replica's session/transport (segment slots recycle ONLY now — the
        crash invariant); a timeout releases nothing and the replica stays
        DRAINING. A DEAD replica drains trivially: nothing is in flight
        that can still complete, and procwire's own close path keeps its
        in-flight slots unrecycled forever. → True once quiesced."""
        with self._lock:
            rep = self._replicas[rid]
            if rep.state == REPLICA_ACTIVE:
                rep.state = REPLICA_DRAINING
                self.stats["drains"] += 1
            if rep.state == REPLICA_QUIESCED:
                return True
            if rep.inflight == 0 or rep.state == REPLICA_DEAD:
                rep.quiesced.set()
        if not rep.quiesced.wait(timeout):
            return False
        with self._lock:
            if rep.state in (REPLICA_DRAINING, REPLICA_DEAD):
                # a released corpse leaves the planners' view too: QUIESCED
                # replicas are neither active nor reclaimable, so a
                # supervisor sweep releases (and re-keys for) each death
                # exactly once
                rep.state = REPLICA_QUIESCED
        self._release(rep)
        return True

    def _release(self, rep: Replica) -> None:
        with self._lock:
            if rep.released:
                return
            rep.released = True
        try:
            rep.session.close()
        # mpklint: disable=MPK105 reason=best-effort release of a quiesced/dead replica session
        except Exception:
            pass
        try:
            rep.transport.close()
        # mpklint: disable=MPK105 reason=best-effort release of a quiesced/dead replica transport
        except Exception:
            pass

    def close(self) -> None:
        """Gateway teardown: release every replica. Unquiesced replicas
        are torn down too — the process is exiting; procwire's own close
        path preserves the crash invariant for anything still in flight."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            self._release(rep)

    # -- hedging ------------------------------------------------------------
    def enable_hedging(self, *, delay: Optional[float] = None,
                       quantile: float = 0.95,
                       budget: Optional[RetryBudget] = None
                       ) -> "RetryBudget":
        """Turn on late-binding request hedging (docs/protocol.md §9):
        a request still PARKED on a busy replica's wire lock after the
        hedge delay is re-routed to a *different* replica instead of
        continuing to wait. The request has not been sent when the hedge
        fires, so exactly ONE wire send ever happens — executed-request
        count is provably unchanged (no dedup races, no double-execution
        window). ``delay`` pins a fixed hedge delay in seconds;
        ``delay=None`` adapts it to the observed ``quantile`` of recent
        dispatch latencies (a :data:`HEDGE_RESERVOIR`-sized window).
        Hedges spend from ``budget`` (a shared :class:`RetryBudget`;
        default a private one) so a fleet-wide stall cannot amplify into
        a re-route storm. → the budget in use."""
        with self._lock:
            self._hedge = True
            self._hedge_delay = None if delay is None else float(delay)
            self._hedge_quantile = float(quantile)
            self.hedge_budget = budget if budget is not None \
                else RetryBudget()
            return self.hedge_budget

    def enable_fair_queue(self, capacity: float, *,
                          quantum: float = WFQ_QUANTUM) -> _FairGate:
        """Turn on weighted fair queuing over the fleet's in-flight slots
        (docs/protocol.md §10): at most ``capacity`` request units in
        flight fleet-wide, with slots granted across backlogged tenants
        by deficit round-robin under the gateway's per-tenant weights
        (:meth:`ServiceGateway.set_tenant_weight`). One tenant's cohort
        backlog can then delay another tenant by at most one cohort per
        round instead of monopolizing every replica. → the gate (for
        observability)."""
        with self._lock:
            if self._fair_gate is not None:
                raise RuntimeError(
                    f"fair queue already enabled for fleet {self.name!r}")
            gate = _FairGate(capacity, weight_of=self.gw._tenant_weight,
                             quantum=quantum)
            self._fair_gate = gate
            return gate

    def _fair_acquire(self, cost: int,
                      deadline: Optional[float]) -> Optional[_FairGate]:
        """Acquire the fair gate (when enabled) for ``cost`` units under
        the calling tenant's flow. → the gate to release, or None when
        fair queuing is off. Sheds typed when the deadline expires while
        parked (nothing charged)."""
        gate = self._fair_gate
        if gate is None:
            return None
        key = current_identity() or "<anon>"
        with self._lock:
            self.stats["fair_queued"] += cost
        if not gate.acquire(key, cost, deadline):
            with self._lock:
                self.stats["expired"] += cost
            raise DeadlineExpired(
                f"service {self.name!r}: deadline expired while queued "
                f"at the fair gate — shed before routing")
        return gate

    def _hedge_after(self) -> Optional[float]:
        """Current hedge delay in seconds, or None when hedging is off /
        has no signal yet (adaptive mode needs a seeded reservoir)."""
        if not self._hedge:
            return None
        if self._hedge_delay is not None:
            return self._hedge_delay
        with self._lock:
            lats = sorted(self._lat_ms)
        if len(lats) < 8:           # not enough signal — don't hedge blind
            return None
        q = lats[min(len(lats) - 1, int(self._hedge_quantile * len(lats)))]
        return q / 1e3

    def _observe_latency(self, ms: float) -> None:
        with self._lock:
            self._lat_ms.append(ms)

    # -- routing ------------------------------------------------------------
    def _route(self, weight: int = 1,
               exclude: Optional[int] = None) -> Replica:
        with self._lock:
            loads = [(r.rid, r.inflight,
                      r.ewma_ms if r.ewma_ms is not None else 0.0)
                     for r in self._replicas.values()
                     if r.state == REPLICA_ACTIVE]
            if exclude is not None and len(loads) > 1:
                # hedge re-route: a DIFFERENT replica when one exists (a
                # single-replica fleet just re-queues on the only wire)
                loads = [t for t in loads if t[0] != exclude]
            if not loads:
                raise ServiceUnavailable(
                    f"service {self.name!r}: no active replicas")
            rep = self._replicas[self.router.pick(loads)]
            rep.inflight += weight
            self.stats["routed"] += weight
            return rep

    def _acquire(self, rep: Replica, deadline: Optional[float],
                 may_hedge: bool) -> str:
        """Admission→submission wait on the replica's wire lock, bounded
        by the propagated deadline and (optionally) the hedge delay.
        → ``"acquired"`` (lock held), ``"expired"`` (deadline passed while
        queued — the request was NEVER sent), or ``"hedge"`` (hedge delay
        passed AND a budget token was granted — re-route, nothing sent)."""
        hedge_after = self._hedge_after() if may_hedge else None
        waited = 0.0
        while True:
            bounds = []
            if deadline is not None:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return "expired"
                bounds.append(rem)
            if hedge_after is not None:
                bounds.append(max(0.0, hedge_after - waited))
            if not bounds:
                rep.rlock.acquire()
                return "acquired"
            t0 = time.monotonic()
            if rep.rlock.acquire(timeout=min(bounds)):
                return "acquired"
            waited += time.monotonic() - t0
            if deadline is not None and time.monotonic() >= deadline:
                return "expired"
            if hedge_after is not None and waited >= hedge_after:
                if self.hedge_budget.take():
                    return "hedge"
                hedge_after = None      # budget dry: wait like an unhedged
                #                         request (no retry-storm boost)

    def _complete(self, rep: Replica, weight: int, elapsed_ms: float,
                  ok: bool) -> None:
        with self._lock:
            rep.inflight -= weight
            if ok:
                rep.served += weight
                per = elapsed_ms / max(1, weight)
                rep.ewma_ms = per if rep.ewma_ms is None else \
                    (1.0 - EWMA_ALPHA) * rep.ewma_ms + EWMA_ALPHA * per
            if rep.state in (REPLICA_DRAINING, REPLICA_DEAD) \
                    and rep.inflight == 0:
                rep.quiesced.set()

    def _mark_dead(self, rep: Replica) -> None:
        with self._lock:
            if rep.state in (REPLICA_DEAD, REPLICA_QUIESCED):
                return
            rep.state = REPLICA_DEAD
            rep.crashes += 1
            self.stats["crashes"] += 1

    def _link_died(self, rep: Replica) -> bool:
        """True when the replica LINK is gone (child death / poisoned
        session) — as opposed to a remote handler raising a typed error
        that merely reconstructs as the same class on this side."""
        s = rep.session
        return bool(getattr(s, "_crashed", False)
                    or getattr(s, "_poisoned", False)
                    or getattr(s, "_closed", False))

    # -- data plane (the service handler / batch_handler) -------------------
    def dispatch(self, payload: torch.Tensor) -> torch.Tensor:
        """Route one request to one replica. Runs on the gateway's session
        service threads / shards — concurrency across replicas is real;
        within a replica, ``rlock`` keeps the session serial.

        The admission→submission wait honors the caller's propagated
        deadline (work that expires while QUEUED is shed typed, never
        sent) and, with :meth:`enable_hedging` on, re-routes a parked
        request to a different replica after the hedge delay — late
        binding: the request has a single wire send either way, so
        hedging can never double-execute. Deliberately does NOT tighten
        the replica wire timeout itself: a mid-exchange ``ResponseTimeout``
        poisons the session and would retire a healthy replica.

        With :meth:`enable_fair_queue` on, routing is preceded by a
        per-tenant DRR grant of one in-flight slot (docs/protocol.md §10)
        keyed on the calling identity (``current_identity``), so a noisy
        tenant's backlog parks at the gate instead of saturating every
        replica."""
        deadline = current_deadline()
        gate = self._fair_acquire(1, deadline)
        try:
            return self._dispatch_routed(payload, deadline)
        finally:
            if gate is not None:
                gate.release(1)

    def _dispatch_routed(self, payload: torch.Tensor,
                         deadline: Optional[float]) -> torch.Tensor:
        attempts = 0
        hedged = False
        exclude: Optional[int] = None
        while True:
            rep = self._route(exclude=exclude)
            exclude = None
            t0 = time.perf_counter()
            ok = False
            try:
                acq = self._acquire(rep, deadline, not hedged)
                if acq == "expired":
                    with self._lock:
                        self.stats["expired"] += 1
                    raise DeadlineExpired(
                        f"service {self.name!r}: deadline expired while "
                        f"queued for replica {rep.rid} — shed before send")
                if acq == "hedge":
                    hedged = True
                    exclude = rep.rid
                    with self._lock:
                        self.stats["hedges_fired"] += 1
                    continue        # finally undoes this rep's admission
                try:
                    if rep.state != REPLICA_ACTIVE \
                            and rep.state != REPLICA_DRAINING:
                        raise _ReplicaGone()
                    if deadline is not None \
                            and time.monotonic() >= deadline:
                        with self._lock:
                            self.stats["expired"] += 1
                        raise DeadlineExpired(
                            f"service {self.name!r}: deadline expired at "
                            f"replica {rep.rid}'s wire — shed before send")
                    out = rep.session.request(payload)
                finally:
                    rep.rlock.release()
                ok = True
                # every completed primary refills the hedge budget — even
                # when the bucket ran dry mid-storm (RetryBudget earning is
                # unconditional), so hedging recovers once load normalizes
                # instead of staying disabled forever
                if self.hedge_budget is not None:
                    self.hedge_budget.note_primary()
                self._observe_latency((time.perf_counter() - t0) * 1e3)
                if hedged:
                    with self._lock:
                        self.stats["hedges_won"] += 1
                return out
            except _ReplicaGone:
                attempts += 1
                with self._lock:
                    self.stats["rerouted"] += 1
                if attempts > 32:
                    raise ServiceUnavailable(
                        f"service {self.name!r}: re-route budget exhausted")
            except DeadlineExpired:
                raise           # a shed, not a replica failure: never
                #                 retires the replica (subclasses
                #                 ResponseTimeout — must precede it)
            except ServiceCrashed:
                if self._link_died(rep):
                    self._mark_dead(rep)
                raise
            except ResponseTimeout:
                # a ring/lockstep deadline expiry poisons the session —
                # the replica can no longer be driven; retire it
                self._mark_dead(rep)
                raise
            finally:
                self._complete(rep, 1, (time.perf_counter() - t0) * 1e3, ok)

    def dispatch_batch(self, payloads) -> list:
        """Cohort-aware admission: the WHOLE batch lands on ONE replica
        and rides its ring as one pipelined ``call_batch`` (ring-windowed
        for cohorts larger than the slot ring). Per-item remote failures
        come back as typed exception instances in their slots (the
        gateway's batch paths map them to per-item typed errors); a child
        death mid-cohort marks the replica DEAD and every not-yet-served
        item of the cohort carries the typed ServiceCrashed.

        Honors the tightest propagated deadline of the cohort (the
        thread-local set by the gateway's batch execution core): a cohort
        that expires while QUEUED for its replica is shed typed before
        the wire. Cohorts never hedge — a cohort binds WHOLE to one
        replica by design (docs/protocol.md §9). With
        :meth:`enable_fair_queue` on, the cohort first takes ``n`` units
        (clamped to the gate's capacity) under its tenant's DRR flow."""
        n = len(payloads)
        deadline = current_deadline()
        with self._lock:
            self.stats["cohorts"] += 1
        gate = self._fair_acquire(n, deadline)
        try:
            return self._dispatch_batch_routed(payloads, n, deadline)
        finally:
            if gate is not None:
                gate.release(n)

    def _dispatch_batch_routed(self, payloads, n: int,
                               deadline: Optional[float]) -> list:
        attempts = 0
        while True:
            rep = self._route(weight=n)
            t0 = time.perf_counter()
            ok = False
            try:
                if self._acquire(rep, deadline, False) == "expired":
                    with self._lock:
                        self.stats["expired"] += n
                    raise DeadlineExpired(
                        f"service {self.name!r}: cohort deadline expired "
                        f"while queued for replica {rep.rid} — shed "
                        "before send")
                try:
                    if rep.state != REPLICA_ACTIVE \
                            and rep.state != REPLICA_DRAINING:
                        raise _ReplicaGone()
                    outs = rep.session.call_batch(payloads,
                                                  return_exceptions=True)
                finally:
                    rep.rlock.release()
                ok = True
                # cohort primaries refill the hedge budget too (earning is
                # unconditional — see RetryBudget.note_primary)
                if self.hedge_budget is not None:
                    self.hedge_budget.note_primary()
            except _ReplicaGone:
                attempts += 1
                with self._lock:
                    self.stats["rerouted"] += n
                if attempts > 32:
                    raise ServiceUnavailable(
                        f"service {self.name!r}: re-route budget exhausted")
                continue
            except DeadlineExpired:
                raise           # shed, not a replica failure (subclasses
                #                 ResponseTimeout — must precede it)
            except (ServiceCrashed, ResponseTimeout):
                if self._link_died(rep):
                    self._mark_dead(rep)
                raise
            finally:
                self._complete(rep, n, (time.perf_counter() - t0) * 1e3, ok)
            if self._link_died(rep):
                self._mark_dead(rep)
            return outs

    # -- observability -------------------------------------------------------
    def snapshot(self) -> List[Dict[str, object]]:
        """Deterministically ordered per-replica view (rid ascending) for
        supervisors and :func:`repro.runtime.elastic.plan_fleet_scaling`."""
        with self._lock:
            return [{"rid": r.rid,
                     "state": _REPLICA_STATE_NAMES[r.state],
                     "inflight": r.inflight,
                     "ewma_ms": None if r.ewma_ms is None
                     else round(r.ewma_ms, 3),
                     "served": r.served,
                     "crashes": r.crashes}
                    for r in self._replicas.values()]


# ---------------------------------------------------------------------------
# the fleet supervisor (self-healing control plane)
# ---------------------------------------------------------------------------

class FleetSupervisor:
    """Health-probing supervision loop over one service's
    :class:`ServiceFleet`: detects DEAD and wedged replicas, ejects
    EWMA-latency outliers, and actuates the pure planners'
    (:func:`repro_torch.runtime.elastic.plan_outlier_ejection`,
    :func:`repro_torch.runtime.elastic.plan_fleet_scaling`) step lists so
    steady-state capacity converges back to ``target`` ACTIVE replicas
    under continuous kill -9 (docs/protocol.md §9).

    One sweep =

    1. **probe** every ACTIVE replica, in seeded-shuffled order: grab its
       wire lock (bounded — a busy wire is NOT a failure) and exchange one
       tiny request. Any response, including a remote typed error, proves
       the link alive; a dead link or a probe timeout retires the replica;
    2. **eject** latency outliers per ``plan_outlier_ejection`` by draining
       them under live traffic;
    3. **converge** per ``plan_fleet_scaling``: release dead replicas,
       respawn the deficit from the fleet's stored spawn spec (each
       membership change exactly one re-key), and drain any surplus.

    Decisions come from pure planners over an immutable snapshot, so a
    recorded trace (``record=True``) replays exactly: :meth:`replay`
    re-derives every sweep's plan from its recorded snapshot and fails
    loudly on the first divergence."""

    def __init__(self, gw: ServiceGateway, name: str, target: int, *,
                 interval: float = 0.25, probe_timeout: float = 1.0,
                 seed: int = 0x53555056, eject_factor: float = 4.0,
                 record: bool = False):
        if target < 1:
            raise ValueError("target must be >= 1")
        self.gw = gw
        self.name = name
        self.target = int(target)
        self.interval = float(interval)
        self.probe_timeout = float(probe_timeout)
        self.seed = seed
        self.eject_factor = float(eject_factor)
        self.record = record
        self._rng = random.Random(seed)
        self._probe_payload = np.zeros(1, np.int32)
        self._draining: set = set()     # ejected/surplus rids to re-drain
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.trace: List[Tuple] = []    # (sweep#, probes, snapshot, plan)
        self.stats = {"sweeps": 0, "probes": 0, "deaths_detected": 0,
                      "ejections": 0, "respawns": 0, "releases": 0,
                      "drains": 0}

    # -- probing ------------------------------------------------------------
    def _probe(self, rep: Replica) -> str:
        """One liveness probe. → ``"alive"`` | ``"dead"`` | ``"busy"``
        (wire lock held past the bound — not probed, not failed)."""
        if not rep.rlock.acquire(timeout=self.probe_timeout):
            return "busy"
        try:
            if rep.state != REPLICA_ACTIVE:
                return "busy"           # decided by another path meanwhile
            try:
                rep.session.request(self._probe_payload,
                                    timeout=self.probe_timeout)
            except (ServiceCrashed, ResponseTimeout):
                # link death, or a probe not answered within the bound (the
                # timeout has poisoned the session: it cannot be driven)
                return "dead"
            except Exception:
                # a remote typed error (the probe payload is not a valid
                # request for every handler): the link answered
                return "alive"
            return "alive"
        finally:
            rep.rlock.release()

    # -- one sweep ----------------------------------------------------------
    def sweep(self) -> list:
        """Run one supervision sweep; → the actuated plan_fleet_scaling
        step list (after probing and outlier ejection)."""
        from repro_torch.runtime.elastic import (plan_fleet_scaling,
                                                 plan_outlier_ejection)
        fleet = self.gw.fleet(self.name)
        sweep_no = self.stats["sweeps"]
        self.stats["sweeps"] += 1

        with fleet._lock:
            actives = [r for r in fleet._replicas.values()
                       if r.state == REPLICA_ACTIVE]
        self._rng.shuffle(actives)
        probes = []
        for rep in actives:
            verdict = self._probe(rep)
            self.stats["probes"] += 1
            probes.append((rep.rid, verdict))
            if verdict == "dead":
                self.stats["deaths_detected"] += 1
                fleet._mark_dead(rep)

        snap = fleet.snapshot()
        for op, rid in plan_outlier_ejection(snap,
                                             factor=self.eject_factor):
            assert op == "eject"
            self.stats["ejections"] += 1
            self._draining.add(rid)

        # re-drain anything decided earlier that has not quiesced yet
        for rid in sorted(self._draining):
            if self.gw.drain_replica(self.name, rid,
                                     timeout=self.probe_timeout):
                self._draining.discard(rid)
                self.stats["drains"] += 1

        snap = fleet.snapshot()
        plan = plan_fleet_scaling(snap, self.target)
        for op, arg in plan:
            if op == "release":
                # a DEAD replica drains trivially; one re-key on release
                if self.gw.drain_replica(self.name, arg,
                                         timeout=self.probe_timeout):
                    self.stats["releases"] += 1
            elif op == "join":
                handler, transport, kwargs = fleet._spawn
                for _ in range(arg):
                    # a fresh replica with its own segment, domain and
                    # epoch; the join epoch-bumps the service exactly once
                    self.gw.register_replica(self.name, handler,
                                             transport=transport,
                                             transport_kwargs=kwargs)
                    self.stats["respawns"] += 1
            elif op == "drain":
                self._draining.add(arg)
        if self.record:
            self.trace.append((sweep_no, tuple(probes), tuple(
                tuple(sorted(r.items())) for r in snap), tuple(plan)))
        return plan

    def replay(self) -> None:
        """Re-derive every recorded sweep's plan from its recorded snapshot
        with the pure planner; raise AssertionError on the first
        divergence."""
        from repro_torch.runtime.elastic import plan_fleet_scaling
        for sweep_no, _probes, snap_t, plan in self.trace:
            snap = [dict(items) for items in snap_t]
            fresh = tuple(plan_fleet_scaling(snap, self.target))
            if fresh != plan:
                raise AssertionError(
                    f"supervisor replay diverged at sweep {sweep_no}: "
                    f"recorded {plan}, replayed {fresh} "
                    f"(seed {self.seed:#x})")

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        # import the planners here: a cold import inside the first sweep
        # would stall the probe loop for its duration
        from repro_torch.runtime import elastic as _elastic  # noqa: F401
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"fleet-supervisor-{self.name}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sweep()
            # mpklint: disable=MPK105 reason=supervision loop must survive any single sweep failure; failures surface via stats/snapshot
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)
            self._thread = None
