"""Per-request context published to in-process handlers (the port of the
context helpers of ``repro.core.gateway``).

A request's remaining deadline budget (the MAC-covered lane-10 word) and
its QoS class (lane 12) are published thread-locally by the service step
(``transports.serve_frame`` / ``serve_batch``) around every handler call,
so the engine can tighten its waits and order its admission by them. The
rest of the gateway (routing, breakers, brownout, fleets) is not ported
yet (see ROADMAP.md).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.core import framing

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


def current_priority() -> int:
    """Priority class of the request the calling thread is executing
    (``PRIO_NORMAL`` outside a request)."""
    return getattr(_BUDGET, "priority", framing.PRIO_NORMAL)


def push_context(deadline: Optional[float], priority: int) -> tuple:
    """Publish a request's deadline and priority; returns what to restore."""
    prev = (getattr(_BUDGET, "deadline", None),
            getattr(_BUDGET, "priority", framing.PRIO_NORMAL))
    _BUDGET.deadline = deadline
    _BUDGET.priority = priority
    return prev


def pop_context(prev: tuple) -> None:
    _BUDGET.deadline, _BUDGET.priority = prev


# priority classes ordered by urgency: HIGH expedites, BULK yields
_PRIO_RANK = {framing.PRIO_HIGH: 0, framing.PRIO_NORMAL: 1,
              framing.PRIO_BULK: 2}


def priority_rank(priority: int) -> int:
    """Scheduling rank of a priority class — lower is more urgent. Unknown
    classes rank as PRIO_NORMAL."""
    return _PRIO_RANK.get(int(priority), 1)


def deadline_of(deadline_us: int) -> Optional[float]:
    """Absolute deadline from a verified frame's lane-10 word (the
    receiver restarts the remaining budget at arrival)."""
    return None if deadline_us == 0 else time.monotonic() + deadline_us / 1e6
