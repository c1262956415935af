"""Deterministic fault-injection fabric for MPKLink gateways (the port of
``repro.core.faultwire``).

Service-mesh practice treats retries, health checks and circuit breaking as
the layer that makes co-located microservices production-grade; this module
is the *test fabric* that proves the gateway's version of that layer. A
seeded :class:`FaultPlan` schedules faults at request indices; a
:class:`FaultFabric` attached to a :class:`~repro_torch.core.gateway.ServiceGateway`
fires the server-side kinds on the wire path, and a :class:`FaultyClient`
fires the client-side kinds by mutating real gateway envelopes. Every run is
exactly replayable from ``(seed, plan)``: the schedule, the mutations and
the typed outcomes are all pure functions of the plan — no wall clock, no
global RNG.

Fault kinds
-----------

client-side (mutated envelopes, sent through the client's own session):

  corrupt_mac     flip one bit of the frame MAC word (or a payload byte)
  truncate        drop frame rows (or send a non-lane-aligned body)
  reorder_seq     frame carries a future sequence number
  stale_replay    frame carries an already-consumed sequence number — the
                  wire image of replaying a captured frame
  forge_identity  valid frame, forged client id in the route words

server-side (fired on the gateway's wire handler):

  crash_handler   kill the transport service thread mid-request
                  (HandlerCrash — the client must get a typed
                  ServiceCrashed immediately, not a full-deadline stall)
  drop_response   execute, then never send the response (DropResponse —
                  the client's bounded wait must expire: ResponseTimeout)
  delay_response  execute, respond ``plan.delay`` seconds late (must stay
                  under the transport deadline and complete)

Expected outcome per kind is in :data:`EXPECTED`; ``None`` means the
request must still complete correctly. A mutated envelope that the gateway
ACCEPTS raises :class:`FaultLeak` — a failed security invariant, never
swallowed.

Replay: ``FaultPlan.from_spec(plan.spec())`` reconstructs the identical
schedule; ``plan.describe()`` is the one-liner chaos tests print on failure.
The step-by-step replay recipe lives in docs/benchmarks.md; the error types
each kind must surface as are normative in docs/protocol.md §7.

In the port the mutated envelopes are tensors on the gateway's device (the
bit flips go through int32 views), and the fabric's wire index is a
``multiprocessing.Value`` of the forkserver context the process transports
start their children from, so it travels in a service child's snapshot and
a re-started child resumes the schedule instead of replaying it from 0.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import framing, procwire
from repro_torch.core.domains import AccessViolation
from repro_torch.core.gateway import (GW_MAGIC, GatewayClient, ServiceGateway,
                                      _ROUTE_BYTES, _route, _OK)
from repro_torch.core.transports import (DropResponse, HandlerCrash,
                                         ResponseTimeout, ServiceCrashed,
                                         TransportError, _raise_remote, _raw)

CLIENT_KINDS: Tuple[str, ...] = ("corrupt_mac", "truncate", "reorder_seq",
                                 "stale_replay", "forge_identity")
SERVER_KINDS: Tuple[str, ...] = ("crash_handler", "drop_response",
                                 "delay_response")
ALL_KINDS: Tuple[str, ...] = CLIENT_KINDS + SERVER_KINDS

# kind → exception type the client MUST see (None: must complete correctly)
EXPECTED: Dict[str, Optional[type]] = {
    "corrupt_mac": framing.FrameError,
    "truncate": framing.FrameError,
    "reorder_seq": framing.FrameError,
    "stale_replay": framing.FrameError,
    "forge_identity": AccessViolation,
    "crash_handler": ServiceCrashed,
    "drop_response": ResponseTimeout,
    "delay_response": None,
}


class FaultLeak(AssertionError):
    """An injected security fault was ACCEPTED by the gateway (or surfaced
    as the wrong type) — a broken isolation invariant, not a test flake."""


@dataclass(frozen=True)
class FaultEvent:
    index: int                  # request index the fault fires at
    kind: str
    param: int = 0              # kind-specific knob (bit/row/cid offset)


class FaultPlan:
    """Seeded, fully deterministic fault schedule over ``n_requests``.

    The schedule is a pure function of ``(seed, n_requests, rate, kinds)``:
    fault indices are a seeded sample of the request range and kinds are
    dealt round-robin then seeded-shuffled, so every kind appears within
    ±1 of its fair share. ``spec()``/``from_spec()`` round-trip the plan for
    replaying a failed run."""

    def __init__(self, seed: int, n_requests: int, rate: float = 0.1,
                 kinds: Optional[Tuple[str, ...]] = None,
                 delay: float = 0.005):
        kinds = tuple(kinds) if kinds else ALL_KINDS
        for k in kinds:
            if k not in ALL_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        self.seed = int(seed)
        self.n_requests = int(n_requests)
        self.rate = float(rate)
        self.kinds = kinds
        self.delay = float(delay)
        rng = random.Random(self.seed)
        n_faults = min(self.n_requests, int(round(self.rate * self.n_requests)))
        indices = sorted(rng.sample(range(self.n_requests), n_faults))
        dealt = [kinds[j % len(kinds)] for j in range(n_faults)]
        rng.shuffle(dealt)
        self.events: Dict[int, FaultEvent] = {
            i: FaultEvent(i, k, rng.randrange(1 << 16))
            for i, k in zip(indices, dealt)}

    # -- replay -----------------------------------------------------------
    def spec(self) -> Dict[str, object]:
        """JSON-safe plan parameters; ``from_spec(spec())`` rebuilds the
        identical schedule."""
        return {"seed": self.seed, "n_requests": self.n_requests,
                "rate": self.rate, "kinds": list(self.kinds),
                "delay": self.delay}

    @classmethod
    def from_spec(cls, spec: Dict[str, object]) -> "FaultPlan":
        """Reconstruct a plan from :meth:`spec` output — the replay path
        for a failed seed."""
        return cls(spec["seed"], spec["n_requests"], spec["rate"],
                   tuple(spec["kinds"]), spec["delay"])

    def describe(self) -> str:
        """One-line replay recipe; chaos tests print this on failure."""
        return (f"FaultPlan.from_spec({self.spec()!r})  "
                f"# {len(self.events)} faults over {self.n_requests} requests")

    def schedule(self) -> List[FaultEvent]:
        """The planned fault events in firing (request-index) order."""
        return [self.events[i] for i in sorted(self.events)]


def _peek_sid(req) -> int:
    """Best-effort service id from a gateway envelope (for crash health)."""
    try:
        head = _raw(req)[:_ROUTE_BYTES].cpu().numpy()
        if head.nbytes >= _ROUTE_BYTES:
            route = head.view("<u4")
            if int(route[0]) == GW_MAGIC:
                return int(route[1])
    # mpklint: disable=MPK105 reason=best-effort peek; malformed routes -> sid 0
    except Exception:
        pass
    return 0


class FaultFabric:
    """Wraps a gateway's wire handler to fire the server-side fault kinds.

    Attach BEFORE traffic starts; each wire message consumes one schedule
    index (with strict single-client traffic, wire index == request index,
    so client- and server-side kinds share one schedule). ``clock`` is the
    sleep function — injectable so tests can run delay faults at zero wall
    cost."""

    def __init__(self, plan: FaultPlan, clock: Callable[[float], None] = time.sleep):
        self.plan = plan
        self.clock = clock
        self.gw: Optional[ServiceGateway] = None
        self.fired: List[FaultEvent] = []
        self._inner: Optional[Callable] = None
        # the wire-fault index lives in shared memory so process transports
        # keep ONE monotonic schedule across children and heals: a
        # re-started service child resumes the count where the dead one
        # stopped. `fired` stays local to whichever process observed the
        # event — chaos assertions on process transports check
        # client-observable outcomes.
        self._index = procwire._CTX.Value("q", 0)
        self._lock = threading.Lock()

    def attach(self, gw: ServiceGateway) -> "FaultFabric":
        """Interpose on ``gw``'s wire handler (live sessions resolve the
        handler per request, so the fabric takes effect immediately).
        One fabric drives one gateway; returns self for chaining."""
        if self._inner is not None:
            raise RuntimeError("fabric already attached")
        self.gw = gw
        self._inner = gw.transport.handler
        gw.transport.handler = self._wire
        return self

    def detach(self):
        """Restore the gateway's original wire handler (idempotent)."""
        if self.gw is not None and self._inner is not None:
            self.gw.transport.handler = self._inner
        self._inner = None

    def _wire(self, req):
        with self._index.get_lock():
            idx = self._index.value
            self._index.value += 1
        ev = self.plan.events.get(idx)
        kind = ev.kind if ev is not None and ev.kind in SERVER_KINDS else None
        if kind == "crash_handler":
            with self._lock:
                self.fired.append(ev)
            if self.gw is not None:
                self.gw.note_wire_crash(_peek_sid(req))
            raise HandlerCrash(
                f"faultwire: injected service crash at request {idx} "
                f"(seed={self.plan.seed})")
        resp = self._inner(req)
        if kind == "delay_response":
            with self._lock:
                self.fired.append(ev)
            self.clock(self.plan.delay)
        elif kind == "drop_response":
            with self._lock:
                self.fired.append(ev)
            raise DropResponse(
                f"faultwire: dropped response at request {idx} "
                f"(seed={self.plan.seed})")
        return resp


@dataclass
class Outcome:
    """One request's fate under the fabric."""
    index: int
    status: str                         # ok | fault | recovered | error
    kind: Optional[str]                 # injected fault kind, if any
    value: object                       # response or exception

    @property
    def ok(self) -> bool:
        return self.status in ("ok", "recovered")


def _flip(frame: torch.Tensor, row: int, lane: int, bit: int) -> None:
    """XOR one bit of a uint32 frame word in place (through an int32 view:
    uint32 tensors take no arithmetic)."""
    v = 1 << bit
    if v >= 1 << 31:
        v -= 1 << 32
    frame.view(torch.int32)[row, lane] ^= v


class FaultyClient:
    """Drives one service through a :class:`GatewayClient` while injecting
    the plan's client-side faults as mutated-but-real gateway envelopes.

    ``step(payload)`` advances the request index by one and returns an
    :class:`Outcome`; injected security faults are *verified* — the gateway
    must reject them with the :data:`EXPECTED` type, anything else raises
    :class:`FaultLeak`. After liveness faults (crash/drop) the client heals
    (fresh session + channel) so the run continues — exactly what a
    production client stack would do."""

    def __init__(self, client: GatewayClient, fabric: FaultFabric,
                 service: str):
        self.client = client
        self.fabric = fabric
        self.service = service
        self.outcomes: List[Outcome] = []
        self._index = 0

    # -- the injected envelopes ------------------------------------------
    def _mutated_env(self, ev: FaultEvent, payload) -> torch.Tensor:
        """Build the attack envelope for ``ev`` against the CURRENT channel
        state (rebuilt per attempt: healing replaces channel seed/seq)."""
        client, gw = self.client, self.client.gw
        chan = client.open(self.service)
        rng = random.Random((self.fabric.plan.seed << 20) ^ ev.index)
        cid = client.cid
        dev = gw.device

        def build(seq):
            return framing.build_frame(payload, seed=chan.seed, seq=seq,
                                       device=dev)
        frame = build(chan.seq)
        if ev.kind == "corrupt_mac":
            if ev.param & 1 and frame.shape[0] > 1:     # payload byte flip
                row = 1 + ev.param % (frame.shape[0] - 1)
                _flip(frame, row, ev.param % framing.LANES, ev.param % 32)
            else:                                        # MAC word bit flip
                _flip(frame, 0, 11, ev.param % 32)
        elif ev.kind == "truncate":
            frame = frame[: max(0, frame.shape[0] - 1 - ev.param % 2)]
        elif ev.kind == "reorder_seq":
            frame = build(chan.seq + 1 + ev.param % 7)
        elif ev.kind == "stale_replay":
            stale = chan.seq - 1 - ev.param % 3 if chan.seq > 0 \
                else chan.seq + 9                       # no past yet: future
            frame = build(max(0, stale))
        elif ev.kind == "forge_identity":
            cid = 0x70000000 + rng.randrange(4096)      # unknown client id
        else:
            raise ValueError(f"not a client-side kind: {ev.kind}")
        route = torch.from_numpy(_route(chan.sid, cid, 0)).to(dev)
        return torch.cat([route, frame.contiguous().reshape(-1)
                          .view(torch.uint8)])

    def _inject(self, ev: FaultEvent, payload) -> BaseException:
        client = self.client
        # the injected envelope itself travels over the (faulty) wire: when
        # a drifted server-side event (drop/crash — possible once client
        # retries have shifted the wire index) eats it, heal and resend —
        # the rejection verdict we are probing for is unaffected
        for attempt in range(4):
            env = self._mutated_env(ev, payload)
            try:
                resp = _raw(client._session.request(env)).cpu().numpy()
                break
            except TransportError:
                if attempt == 3:
                    raise
                client.heal(self.service)
        route = resp[:_ROUTE_BYTES].view("<u4")
        if int(route[1]) == _OK:
            raise FaultLeak(
                f"gateway ACCEPTED injected {ev.kind} at request {ev.index} "
                f"— replay: {self.fabric.plan.describe()}")
        try:
            _raise_remote(resp[_ROUTE_BYTES:
                               _ROUTE_BYTES + int(route[3])].tobytes())
        except EXPECTED[ev.kind] as e:                   # the REQUIRED type
            return e
        except Exception as e:
            raise FaultLeak(
                f"injected {ev.kind} at request {ev.index} surfaced as "
                f"{type(e).__name__}, expected {EXPECTED[ev.kind].__name__} "
                f"— replay: {self.fabric.plan.describe()}")

    # -- one request under the plan --------------------------------------
    def step(self, payload) -> Outcome:
        idx = self._index
        self._index += 1
        ev = self.fabric.plan.events.get(idx)
        if ev is not None and ev.kind in CLIENT_KINDS:
            exc = self._inject(ev, payload)
            out = Outcome(idx, "fault", ev.kind, exc)
        else:
            try:
                resp = self.client.call(self.service, payload)
            except (TransportError, AccessViolation,
                    framing.FrameError) as e:
                self.client.heal(self.service)           # keep the run alive
                if ev is not None:
                    expected = EXPECTED[ev.kind]
                    if expected is None or not isinstance(e, expected):
                        raise FaultLeak(
                            f"injected {ev.kind} at request {idx} surfaced "
                            f"as {type(e).__name__}, expected "
                            f"{getattr(expected, '__name__', 'success')} — "
                            f"replay: {self.fabric.plan.describe()}")
                    out = Outcome(idx, "fault", ev.kind, e)
                else:
                    out = Outcome(idx, "error", None, e)
            else:
                out = Outcome(idx, "recovered" if ev is not None else "ok",
                              ev.kind if ev is not None else None, resp)
        self.outcomes.append(out)
        return out

    def counts(self) -> Dict[str, int]:
        """Outcome tally so far: ok / fault (injected, typed as required) /
        recovered (delay faults that completed) / error (anything else —
        chaos gates require this to stay 0)."""
        c: Dict[str, int] = {"ok": 0, "fault": 0, "recovered": 0, "error": 0}
        for o in self.outcomes:
            c[o.status] += 1
        return c
