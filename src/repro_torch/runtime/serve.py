"""Serving engine: continuous batching over a fixed slot grid (the port of
``repro.runtime.serve``).

Requests (prompts) occupy slots of a size-B decode batch; every engine tick
runs ONE decode_step for all slots with per-slot positions (the per-slot KV
insert is ``kvcache.dense_cache_insert_rows``; the SSM family carries a
recurrent state per slot instead, and the hybrid family both: a recurrent
state per mamba layer and a KV cache per insertion of its shared attention
block). New requests join as slots
free up. Prompt tokens are fed incrementally through the same decode path
(teacher-forced), then generation continues from the model's samples until
EOS/max_new.

Each tick syncs with the host as the reference does: the sampled tokens go
to numpy and every live slot's position is read back one by one.

While the span recorder (:mod:`repro_torch.tracing`) is armed, a tick is
the span ``engine.tick`` (attributes ``live``, ``admitted`` and
``host_reads``, every device-to-host read it makes) over ``engine.admit``,
``engine.decode_step`` (the host's dispatch of the step, its tokens'
upload included), ``engine.sample`` (with the read of the sampled tokens)
and ``engine.bookkeep`` (the per-slot loop); each admission emits
``engine.queued``, from the handler's entry to the admission, with the
request's call id and ``rid``. The service's handler is ``service.handler``
over ``service.submit`` (the lock wait and the submission).

The engine refuses what the reference's cannot serve: a state past a
sliding window (a ring cache takes one position for the whole batch, and
resetting a slot's row would corrupt its slot positions) and an
encoder-decoder model (whose state needs an encoder output per request).

Sampling is greedy by default; with ``greedy=False`` each tick samples the
last logits' categorical through a ``torch.Generator`` on the logits'
device, seeded from ``seed`` (JAX's PRNG stream is not reproduced, so the
two packages agree in distribution, not token for token).

Replica fleets (:func:`register_engine_fleet`) serve one engine a replica,
each behind its own transport, by default in a process of its own
(``mpklink_opt_proc``). The replica's handler (:class:`FleetHandler`)
pickles: it carries an engine factory (a ``functools.partial`` of a
module-level builder such as :func:`seeded_engine`) and builds its
:class:`EngineService` lazily in the child, because threads do not cross a
process boundary.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core import gateway
from repro_torch.core.transports import DeadlineExpired, ServiceCrashed
from repro_torch.device import resolve
from repro_torch.models import decode_step, init_decode_state
from repro_torch.models.transformer import Impl
from repro_torch.tree import leaves


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    eos_id: Optional[int] = None
    # lane-12 QoS class (framing.PRIO_*): urgent requests are admitted to
    # freed decode slots ahead of older bulk work
    priority: int = 0
    # filled by the engine
    generated: List[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    finished_at: float = 0.0
    # the service handler's entry (0: submitted to the engine directly) and
    # the gateway call it serves (tracing.call_id; None unless armed)
    entered_at: float = 0.0
    call: Optional[int] = None


class ServingEngine:
    """``params`` must lie on ``device``; the decode state is allocated
    there. The KV caches are updated in place every tick. ``greedy=False``
    samples from ``softmax(logits)`` with a generator seeded from
    ``seed``."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_seq: int = 256, impl: Impl = Impl(),
                 dtype=torch.float32, device="cuda", greedy: bool = True,
                 seed: int = 0):
        if cfg.swa_window is not None and max_seq > cfg.swa_window:
            raise ValueError("ring caches need uniform positions; lower "
                             "max_seq or use a dense model")
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: its decode "
                             f"state needs each request's encoder output; decode "
                             f"it through runtime.steps.make_decode_step")
        self.device = resolve(device)
        self.cfg, self.params = cfg, params
        self.B, self.max_seq = max_batch, max_seq
        self.impl, self.dtype = impl, dtype
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        state = init_decode_state(cfg, max_batch, max_seq, dtype=dtype,
                                  device=self.device)
        state["pos"] = torch.zeros((max_batch,), dtype=torch.int32,
                                   device=self.device)
        self.state = state

        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self.current_token = np.zeros((max_batch, 1), np.int64)
        self.prompt_cursor = np.zeros(max_batch, np.int64)
        self.completed: List[Request] = []
        self.ticks = 0

    # -- request management -----------------------------------------------
    def submit(self, req: Request):
        req.submitted_at = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> int:
        """Board queued requests into free slots; → how many boarded."""
        n = 0
        for b in range(self.B):
            if self.slots[b] is None and self.queue:
                # priority-aware admission: the most urgent class boards
                # first, FIFO within a class
                i = min(range(len(self.queue)),
                        key=lambda k: (gateway.priority_rank(
                            self.queue[k].priority), k))
                req = self.queue.pop(i)
                req.admitted_at = time.perf_counter()
                if tracing.RECORDER.armed:
                    tracing.emit("engine.queued",
                                 int(1e9 * (req.entered_at or req.submitted_at)),
                                 int(1e9 * req.admitted_at), call=req.call,
                                 rid=req.rid)
                req.slot = b
                self.slots[b] = req
                n += 1
                # reset slot: zero its row of every leaf of the (nested)
                # decode state, KV caches and SSM states alike, and its
                # position
                for leaf in leaves(self.state["caches"]):
                    leaf[:, b] = 0
                self.state["pos"][b] = 0
                self.current_token[b, 0] = req.prompt[0]
                self.prompt_cursor[b] = 1
        return n

    def _retire(self, b: int):
        req = self.slots[b]
        req.done = True
        req.finished_at = time.perf_counter()
        self.completed.append(req)
        self.slots[b] = None

    # -- engine tick ---------------------------------------------------------
    def tick(self):
        with tracing.span("engine.tick") as sp:
            with tracing.span("engine.admit"):
                admitted = self._admit()
            if all(s is None for s in self.slots):
                if sp:
                    sp.set(live=0, admitted=admitted, host_reads=0)
                return False
            with tracing.span("engine.decode_step"):
                tokens = torch.from_numpy(self.current_token).to(self.device)
                with torch.no_grad():
                    logits, self.state = decode_step(
                        self.cfg, self.params, self.state, tokens,
                        impl=self.impl, dtype=self.dtype)
            with tracing.span("engine.sample"):
                nxt = self.sample(logits[:, -1]).cpu().numpy()
            self.ticks += 1
            if sp:
                sp.set(live=sum(s is not None for s in self.slots),
                       admitted=admitted)
            reads = 1                               # the sampled tokens
            with tracing.span("engine.bookkeep"):
                for b, req in enumerate(self.slots):
                    if req is None:
                        continue
                    cur = int(self.prompt_cursor[b])
                    if cur < len(req.prompt):      # still feeding the prompt
                        self.current_token[b, 0] = req.prompt[cur]
                        self.prompt_cursor[b] = cur + 1
                        continue
                    tok = int(nxt[b])
                    req.generated.append(tok)
                    self.current_token[b, 0] = tok
                    pos = int(self.state["pos"][b])
                    reads += 1
                    if (len(req.generated) >= req.max_new
                            or (req.eos_id is not None and tok == req.eos_id)
                            or pos >= self.max_seq - 1):
                        self._retire(b)
            if sp:
                sp.set(host_reads=reads)
        return True

    def sample(self, last: torch.Tensor) -> torch.Tensor:
        """Next tokens (B,) from the last logits (B, V): the argmax, or a
        draw from their categorical with the engine's generator."""
        if self.greedy:
            return last.argmax(-1)
        probs = torch.softmax(last.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def run_until_drained(self, max_ticks: int = 10_000):
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.ticks < max_ticks:
            self.tick()
        return self.completed

    def reset(self) -> List[Request]:
        """Crash recovery: drop all in-flight work and return to an empty
        slot grid (caches/positions are re-zeroed per slot on admit).
        → the requests that were lost (queued + slotted)."""
        lost = [r for r in self.slots if r is not None] + list(self.queue)
        self.slots = [None] * self.B
        self.queue = []
        self.current_token[:] = 0
        self.prompt_cursor[:] = 0
        self.state["pos"] = torch.zeros((self.B,), dtype=torch.int32,
                                        device=self.device)
        return lost


# ---------------------------------------------------------------------------
# service front-end
# ---------------------------------------------------------------------------

def encode_prompt(prompt: List[int], max_new: int = 16) -> np.ndarray:
    """Wire format for EngineService: int32 [max_new, *prompt]."""
    return np.asarray([max_new, *prompt], np.int32)


class EngineService:
    """Thread-safe inference service over a :class:`ServingEngine`.

    The engine itself is single-threaded. This wrapper runs the tick loop
    on ONE background thread and lets N concurrent callers (service-step
    threads) submit prompts and block until their request retires —
    continuous batching absorbs the concurrency.

    ``handler`` takes the request payload int32 ``[max_new, tok0, tok1,
    ...]`` (see :func:`encode_prompt`; a tensor on any device or an array)
    and returns the int32 generated-token array.

    Self-healing: if the tick loop dies mid-decode, every in-flight request
    fails with a typed :class:`ServiceCrashed`, the slot grid resets, and
    the service keeps serving.
    """

    def __init__(self, engine: ServingEngine, *, timeout: float = 300.0,
                 idle_wait: float = 0.02):
        self.engine = engine
        self.timeout = timeout
        self._idle_wait = idle_wait
        self._lock = threading.Lock()           # guards engine + tables
        self._events: Dict[int, threading.Event] = {}
        self._done: Dict[int, Request] = {}
        self._failed: Dict[int, BaseException] = {}
        self._abandoned: set = set()            # timed-out rids: drop results
        self._rid = itertools.count()
        self._consumed = 0                      # engine.completed drained so far
        self._work = threading.Event()          # submit signal for idle loop
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.crashes = 0                        # tick-loop crashes survived
        self.cohorts: List[int] = []            # batch-submission sizes seen
        self._inject_crash = False              # test hook: die on next tick

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "EngineService":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="engine-service")
            self._thread.start()
        return self

    def close(self):
        with self._lock:                # a handler registers under it
            self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._lock:
            pending = list(self._events.values())
            self._events.clear()
        for ev in pending:
            ev.set()

    # -- tick loop (one thread owns the engine) -----------------------------
    def inject_crash(self):
        """Chaos hook: make the next engine tick die (deterministically)."""
        self._inject_crash = True
        self._work.set()

    def _recover(self, cause: BaseException):
        """Deliver anything that finished during the dying tick, fail every
        in-flight request with a typed ServiceCrashed now, reset the engine,
        keep serving."""
        with self._lock:
            self.crashes += 1
            events = []
            for req in self.engine.completed[self._consumed:]:
                if req.rid in self._abandoned:
                    self._abandoned.discard(req.rid)
                    continue
                self._done[req.rid] = req
                events.append(self._events.pop(req.rid, None))
            del self.engine.completed[:]
            self._consumed = 0
            lost = self.engine.reset()
            exc = ServiceCrashed(
                f"engine worker crashed mid-decode ({type(cause).__name__}: "
                f"{cause}); request lost — safe to retry")
            for req in lost:
                if req.rid in self._abandoned:
                    self._abandoned.discard(req.rid)
                    continue
                self._failed[req.rid] = exc
                events.append(self._events.pop(req.rid, None))
        for ev in events:
            if ev is not None:
                ev.set()

    def _run(self):
        while not self._stop.is_set():
            try:
                with self._lock:
                    if self._inject_crash:
                        self._inject_crash = False
                        raise RuntimeError("injected engine crash")
                    progressed = self.engine.tick()
                    fresh = self.engine.completed[self._consumed:]
                    del self.engine.completed[:]
                    self._consumed = 0
                    for req in fresh:
                        if req.rid in self._abandoned:  # caller timed out
                            self._abandoned.discard(req.rid)
                            continue
                        self._done[req.rid] = req
                    events = [self._events.pop(r.rid, None) for r in fresh]
            except Exception as e:      # a dead tick loop strands callers —
                self._recover(e)        # heal and keep serving instead
                continue
            for ev in events:
                if ev is not None:
                    ev.set()
            if not progressed:
                self._work.wait(timeout=self._idle_wait)
                self._work.clear()

    # -- service handler (called from N service-step threads) ---------------
    @staticmethod
    def _parse_req(req):
        """Wire payload int32 ``[max_new, tok0, ...]`` → (max_new, prompt).
        A payload of another dtype is reinterpreted as int32 words."""
        if isinstance(req, torch.Tensor):
            req = req.detach().cpu().numpy()
        arr = np.asarray(req)
        if arr.dtype != np.int32:
            arr = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.int32)
        arr = arr.reshape(-1)
        if arr.size < 2:
            raise ValueError("inference request needs [max_new, tok0, ...]")
        return int(arr[0]), [int(t) for t in arr[1:]]

    def _cancel(self, rid: int):
        """Forget an in-flight request (finished, queued or decoding)."""
        self._events.pop(rid, None)
        if self._done.pop(rid, None) is not None \
                or self._failed.pop(rid, None) is not None:
            return
        before = len(self.engine.queue)
        self.engine.queue = [r for r in self.engine.queue if r.rid != rid]
        if len(self.engine.queue) == before:
            self._abandoned.add(rid)

    def _await(self, rid: int, ev: threading.Event,
               deadline: float) -> np.ndarray:
        """Block until ``rid`` retires (bounded by ``deadline``); return its
        generated tokens or raise its typed failure."""
        ev.wait(timeout=max(0.0, deadline - time.monotonic()))
        with self._lock:
            done = self._done.pop(rid, None)
            failed = self._failed.pop(rid, None)
        if done is not None:
            return np.asarray(done.generated, np.int32)
        if failed is not None:
            raise failed
        if self._stop.is_set():
            raise RuntimeError(
                f"EngineService closed while request {rid} was in flight")
        with self._lock:
            self._cancel(rid)
        remaining = gateway.remaining_budget()
        if remaining is not None and remaining <= 0:
            raise DeadlineExpired(
                f"inference request {rid}: caller's propagated deadline "
                "expired while decoding — request cancelled")
        raise TimeoutError(f"inference request {rid} timed out "
                           f"after {self.timeout}s")

    def _deadline(self) -> float:
        """The service's bound, tightened by the caller's propagated budget."""
        remaining = gateway.remaining_budget()
        bound = self.timeout if remaining is None \
            else min(self.timeout, max(0.0, remaining))
        return time.monotonic() + bound

    def handler(self, req) -> np.ndarray:
        """One prompt in, one int32 token array out. Blocks until the
        request retires from the shared decode batch or its deadline. A
        closed service refuses it at once: the close check and the
        registration share one hold of the lock, which ``close`` takes to
        set its flag."""
        with tracing.span("service.handler"):
            entered = time.perf_counter()
            max_new, prompt = self._parse_req(req)
            prio = gateway.current_priority()
            call = gateway.current_call()
            ev = threading.Event()
            with tracing.span("service.submit"):
                with self._lock:
                    if self._stop.is_set():
                        raise RuntimeError("EngineService is closed")
                    rid = next(self._rid)
                    self._events[rid] = ev
                    self.engine.submit(Request(
                        rid=rid, prompt=prompt, max_new=max_new,
                        priority=prio, entered_at=entered, call=call))
            self._work.set()
            return self._await(rid, ev, self._deadline())

    def handler_batch(self, reqs) -> List[np.ndarray]:
        """Batched prompt submission: all N prompts enter the engine queue
        under one lock acquisition and one wake signal, so they join the
        slot grid as a cohort. Returns the N token arrays in order; if any
        request fails its typed error is raised and the rest of the cohort
        is cancelled."""
        entered = time.perf_counter()
        parsed = [self._parse_req(r) for r in reqs]
        prio = gateway.current_priority()   # the cohort's most-urgent class
        waits = []
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("EngineService is closed")
            self.cohorts.append(len(parsed))
            for max_new, prompt in parsed:
                rid = next(self._rid)
                ev = threading.Event()
                self._events[rid] = ev
                self.engine.submit(
                    Request(rid=rid, prompt=prompt, max_new=max_new,
                            priority=prio, entered_at=entered))
                waits.append((rid, ev))
        self._work.set()
        deadline = self._deadline()
        outs: List[np.ndarray] = []
        for k, (rid, ev) in enumerate(waits):
            try:
                outs.append(self._await(rid, ev, deadline))
            except BaseException:
                with self._lock:        # don't strand the rest of the cohort
                    for later_rid, _ in waits[k + 1:]:
                        self._cancel(later_rid)
                raise
        return outs


# ---------------------------------------------------------------------------
# replica fleets (N engines behind one service name)
# ---------------------------------------------------------------------------

def seeded_engine(arch: str, seed: int, *, max_batch: int = 8,
                  max_seq: int = 256, dtype: str = "bfloat16",
                  device="cuda", reduced: bool = False) -> ServingEngine:
    """A :class:`ServingEngine` over random weights of ``arch`` (its full
    configuration, or the reduced one) drawn from ``seed`` on ``device``.
    Module-level, so ``functools.partial`` of it is an engine factory that
    pickles: every replica process builds the same weights from the
    seed."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import init_params
    cfg = get_reduced(arch) if reduced else get_config(arch)
    dev = resolve(device)
    dt = getattr(torch, dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dtype=dt)
    return ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                         dtype=dt, device=dev)


# a request no prompt can equal (max_new < 0): a replica answers it with
# its engine's counters instead of serving it
FLEET_STATS = np.array([-1, 0x53544154], np.int32)


class FleetHandler:
    """Service handler for one engine replica (what :func:`fleet_handler`
    returns).

    The :class:`EngineService` — engine, slot grid and its tick thread — is
    built lazily on the first request, in the process that serves it: a
    process replica pickles this handler without a service and builds its
    own engine in the child. The :data:`FLEET_STATS` request returns the
    replica's counters as JSON bytes: ``ticks`` (engine ticks),
    ``launches`` (its process's ``ops.LAUNCHES``) and ``card_bytes`` (what
    its process holds allocated on the card; 0 on the CPU)."""

    def __init__(self, engine_factory: Callable[[], ServingEngine], *,
                 timeout: float = 300.0):
        self.engine_factory = engine_factory
        self.timeout = timeout
        self._svc: Optional[EngineService] = None
        self._lock = threading.Lock()

    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_svc"], state["_lock"]   # each process builds its own
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._svc = None
        self._lock = threading.Lock()

    def service(self) -> EngineService:
        with self._lock:
            if self._svc is None:
                self._svc = EngineService(self.engine_factory(),
                                          timeout=self.timeout).start()
            return self._svc

    def __call__(self, req) -> np.ndarray:
        svc = self.service()
        if _is_stats(req):
            from repro_torch.kernels import ops
            dev = svc.engine.device
            doc = {"ticks": svc.engine.ticks,
                   "launches": ops.LAUNCHES.snapshot(),
                   "card_bytes": torch.cuda.memory_allocated(dev)
                   if dev.type == "cuda" else 0}
            return np.frombuffer(json.dumps(doc).encode(), np.uint8).copy()
        return svc.handler(req)

    def close(self):
        with self._lock:
            if self._svc is not None:
                self._svc.close()
                self._svc = None


def _is_stats(req) -> bool:
    if isinstance(req, torch.Tensor):
        if req.numel() * req.element_size() != FLEET_STATS.nbytes:
            return False
        words = req.detach().reshape(-1).view(torch.uint8).cpu().numpy()
    else:
        words = np.ascontiguousarray(req).reshape(-1).view(np.uint8)
        if words.nbytes != FLEET_STATS.nbytes:
            return False
    return bool((words.view(np.int32) == FLEET_STATS).all())


def fleet_handler(engine_factory: Callable[[], ServingEngine], *,
                  timeout: float = 300.0) -> FleetHandler:
    """Service handler for one engine replica: a :class:`FleetHandler`
    that builds its engine lazily where it serves (in the replica's
    process, for a process transport)."""
    return FleetHandler(engine_factory, timeout=timeout)


def register_engine_fleet(gw, name: str,
                          engine_factory: Callable[[], ServingEngine],
                          replicas: int, *,
                          transport: str = "mpklink_opt_proc",
                          transport_kwargs: Optional[dict] = None,
                          timeout: float = 300.0) -> List[int]:
    """Register ``replicas`` independent engine replicas behind one service
    name on ``gw`` (a :class:`repro_torch.core.gateway.ServiceGateway`).
    Each replica is its own transport instance — own protection domain,
    epoch and segment, and for process transports its own child process
    running a private engine through :func:`fleet_handler`. → the replica
    ids, in join order."""
    return [gw.register_replica(name, fleet_handler(engine_factory,
                                                    timeout=timeout),
                                transport=transport,
                                transport_kwargs=transport_kwargs)
            for _ in range(replicas)]
