"""Fault tolerance primitives: heartbeats, failure injection, straggler
detection, and the gateway supervisor (a copy of ``repro.runtime.fault``).

On one device the *detection/decision logic* is what runs and is
unit-tested; the actuation path (restore checkpoint, resume) is exercised
end-to-end by runtime/train_loop.py with injected failures. On a cluster
the same monitor would consume per-host heartbeats instead of thread pings.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set


@dataclass
class WorkerState:
    last_beat: float
    alive: bool = True


class HeartbeatMonitor:
    """Workers beat every ``interval``; silence > ``timeout`` → failed."""

    def __init__(self, workers: List[str], timeout: float = 5.0):
        now = time.monotonic()
        self.timeout = timeout
        self._workers: Dict[str, WorkerState] = {
            w: WorkerState(now) for w in workers}
        self._lock = threading.Lock()

    def beat(self, worker: str, at: Optional[float] = None):
        with self._lock:
            st = self._workers.get(worker)
            if st is not None:
                st.last_beat = at if at is not None else time.monotonic()

    def ensure(self, worker: str):
        """Start tracking a late-arriving worker (no-op if known)."""
        with self._lock:
            if worker not in self._workers:
                self._workers[worker] = WorkerState(time.monotonic())

    def revive(self, worker: str, at: Optional[float] = None):
        """A recovered worker beats AND is marked alive again (a plain beat
        does not resurrect: check() latches failure)."""
        with self._lock:
            st = self._workers.get(worker)
            if st is not None:
                st.alive = True
                st.last_beat = at if at is not None else time.monotonic()

    def mark_failed(self, worker: str):
        """Explicit failure injection (tests / external signal)."""
        with self._lock:
            if worker in self._workers:
                self._workers[worker].alive = False

    def check(self, at: Optional[float] = None) -> Set[str]:
        """→ set of failed workers as of ``at``."""
        now = at if at is not None else time.monotonic()
        failed = set()
        with self._lock:
            for name, st in self._workers.items():
                if not st.alive or (now - st.last_beat) > self.timeout:
                    st.alive = False
                    failed.add(name)
        return failed

    def alive(self) -> List[str]:
        with self._lock:
            return [w for w, st in self._workers.items() if st.alive]


class StragglerDetector:
    """Deadline-based: a worker whose step time exceeds ``factor`` × the
    rolling median is a straggler. Mitigation at pod scale = drop its
    gradient contribution for the step (DP redundancy) or re-dispatch; the
    decision is returned to the caller, the training loop records it."""

    def __init__(self, window: int = 32, factor: float = 2.0):
        self.window = window
        self.factor = factor
        self._times: deque = deque(maxlen=window)

    def observe(self, step_time: float) -> bool:
        """→ True if this step was a straggler vs the rolling median."""
        times = sorted(self._times)
        self._times.append(step_time)
        if len(times) < 8:
            return False
        median = times[len(times) // 2]
        return step_time > self.factor * median

    @property
    def median(self) -> Optional[float]:
        if not self._times:
            return None
        t = sorted(self._times)
        return t[len(t) // 2]


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples:
    {step: [worker, ...]} — at that step the monitor marks them failed."""
    schedule: Dict[int, List[str]] = field(default_factory=dict)

    def fire(self, step: int, monitor: HeartbeatMonitor) -> List[str]:
        failed = self.schedule.get(step, [])
        for w in failed:
            monitor.mark_failed(w)
        return failed


@dataclass
class GuardTripError(RuntimeError):
    """A fabric channel MAC verification failed — corrupted exchange.
    The training loop catches this and retries the step from the last
    known-good state (the paper's tamper-detection, actioned)."""
    step: int
    detail: str = ""


class GatewaySupervisor:
    """Service-level incarnation of the worker heartbeat loop: feeds a
    :class:`HeartbeatMonitor` from a gateway's per-service health and
    actuates the recovery plan (restart / shed / leave-open) that
    :func:`repro_torch.runtime.elastic.plan_gateway_recovery` decides.

    The gateway already self-heals inline for services registered with a
    ``factory``; the supervisor is the out-of-band sweep that (a) restarts
    factory-less services an operator has since given a factory, (b) keeps
    the monitor's alive/failed view consistent for dashboards, and (c) is
    the single place a control loop calls on its cadence."""

    def __init__(self, gateway, timeout: float = 5.0):
        self.gateway = gateway
        self.monitor = HeartbeatMonitor(list(gateway._services), timeout)
        self.log: list = []            # (tick, action, service) audit trail
        self._tick = 0

    def observe(self) -> Dict[str, Dict[str, object]]:
        """Pull the gateway health snapshot into the heartbeat view."""
        snap = self.gateway.health()
        for name, h in snap.items():
            self.monitor.ensure(name)               # late-registered service
            if h["state"] == "closed":
                self.monitor.revive(name)
            else:
                self.monitor.mark_failed(name)
        return snap

    def heal(self) -> list:
        """One supervision sweep: observe, plan, actuate. → actions taken."""
        from repro_torch.runtime.elastic import plan_gateway_recovery
        snap = self.observe()
        restartable = {n for n, s in self.gateway._services.items()
                       if s.factory is not None}
        actions = plan_gateway_recovery(snap, restartable)
        self._tick += 1
        for action, name in actions:
            if action == "restart":
                self.gateway.restart_service(name)
            self.log.append((self._tick, action, name))
        return actions
