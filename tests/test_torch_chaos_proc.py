"""The reference's process-transport chaos cases (``tests/test_chaos.py``,
the ``proc`` half) run against the port on the CPU, under their own
names: a ``ServiceGateway`` whose own transport is a process transport is
sent to its service process, and the crash fault is a real ``kill -9`` of
that process (heals start a fresh child). Same contract clauses: nothing
hangs, every injected fault is typed as EXPECTED, an identical seed gives
identical outcomes (the fabric's shared index travels in each child's
snapshot, so a re-started child resumes the schedule). Assertions are
client-observable only: the fabric's ``fired`` lives in the child."""
import signal
import time

import pytest
import torch

import torch_proc_handlers as H
from repro_torch.core import PROC_TRANSPORTS, ServiceGateway as _Gateway
from repro_torch.core.faultwire import (ALL_KINDS, EXPECTED, FaultFabric,
                                        FaultPlan, FaultyClient)
from repro_torch.core.transports import ServiceCrashed
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler

pytestmark = pytest.mark.proc

TIMEOUT = 0.4                      # transport response deadline under chaos
WALL_BUDGET = 60.0                 # hard per-run bound: nothing may hang


@pytest.fixture(autouse=True, scope="module")
def _port_proc_hygiene(request):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    H.proc_hygiene(request.module.__name__)


@pytest.fixture(autouse=True)
def _bounded():
    with H.bounded(120):
        yield


def ServiceGateway(*args, **kw):
    kw.setdefault("device", "cpu")
    return _Gateway(*args, **kw)


def _chaos_gateway(transport: str):
    gw = ServiceGateway(transport, transport_kwargs={"timeout": TIMEOUT})
    gw.register_service("wordcount", wordcount_handler,
                        factory=H.wordcount_factory)
    return gw.start()


def _run(transport: str, plan: FaultPlan, *, retries: int = 0):
    gw = _chaos_gateway(transport)
    fab = FaultFabric(plan).attach(gw)
    fc = FaultyClient(gw.connect("chaos-client", retries=retries), fab,
                      "wordcount")
    t0 = time.perf_counter()
    try:
        for i in range(plan.n_requests):
            n = 4 + i % 9
            out = fc.step(make_text(n, seed=i))
            if out.status == "ok":
                assert parse_count(out.value) == n, \
                    f"wrong answer at request {i} — replay: {plan.describe()}"
    finally:
        wall = time.perf_counter() - t0
        gw.close()
    sig = [(o.index, o.status, o.kind, type(o.value).__name__)
           for o in fc.outcomes]
    return sig, wall, fc


@pytest.mark.parametrize("name", sorted(PROC_TRANSPORTS))
def test_chaos_proc_all_kinds_bounded_and_typed(name):
    """Full-kind plan against a real service process: every fault typed,
    every wait bounded, zero collateral failures — with crash faults
    killing (and heals re-starting) actual OS processes."""
    plan = FaultPlan(seed=2024, n_requests=40, rate=0.25)
    sig, wall, fc = _run(name, plan)
    assert wall < WALL_BUDGET, f"hung? {wall}s — replay: {plan.describe()}"
    counts = fc.counts()
    assert counts["error"] == 0, \
        (f"non-faulted request failed: "
         f"{[s for s in sig if s[1] == 'error']} — replay: {plan.describe()}")
    for o in fc.outcomes:
        if o.status == "fault":
            assert isinstance(o.value, EXPECTED[o.kind]), \
                f"{o} — replay: {plan.describe()}"


@pytest.mark.parametrize("name", sorted(PROC_TRANSPORTS))
@pytest.mark.parametrize("kind", ALL_KINDS)
def test_chaos_proc_single_kind(name, kind):
    """8 fault kinds × 3 process transports, ≥2 injections each,
    replayable from (seed, plan)."""
    plan = FaultPlan(seed=hash((name, kind)) & 0xFFFF, n_requests=12,
                     rate=0.25, kinds=(kind,))
    assert len(plan.events) >= 2
    sig, wall, fc = _run(name, plan)
    assert wall < WALL_BUDGET, f"hung? — replay: {plan.describe()}"
    assert fc.counts()["error"] == 0, f"replay: {plan.describe()}"
    expected = EXPECTED[kind]
    for o in fc.outcomes:
        if o.kind != kind:
            continue
        if expected is None:                       # delay: must complete
            assert o.ok, f"{o} — replay: {plan.describe()}"
        elif o.status == "fault":
            assert isinstance(o.value, expected), \
                f"{o} — replay: {plan.describe()}"


@pytest.mark.parametrize("name", ["mpklink_opt_proc", "shm_proc"])
def test_chaos_proc_identical_seed_identical_outcomes(name):
    """(c) across process boundaries: the shared-memory fault index keeps
    the schedule monotonic across children and heals, so two full runs
    still fingerprint identically."""
    spec = FaultPlan(seed=777, n_requests=30, rate=0.3).spec()
    p1, p2 = FaultPlan.from_spec(spec), FaultPlan.from_spec(spec)
    sig1, _, _ = _run(name, p1)
    sig2, _, _ = _run(name, p2)
    assert sig1 == sig2, f"nondeterministic — replay: {p1.describe()}"


def test_chaos_proc_crash_is_a_real_sigkill():
    """The crash fault kind must actually kill -9 the service process —
    not just raise in a thread. Verified via the dead child's exitcode."""
    gw = _chaos_gateway("mpklink_opt_proc")
    sessions = []
    orig_connect = gw.transport.connect

    def tracking_connect(*a, **kw):
        s = orig_connect(*a, **kw)
        sessions.append(s)
        return s

    gw.transport.connect = tracking_connect
    plan = FaultPlan(seed=9, n_requests=8, rate=0.5,
                     kinds=("crash_handler",))
    assert len(plan.events) >= 2
    fab = FaultFabric(plan).attach(gw)
    fc = FaultyClient(gw.connect("chaos-client"), fab, "wordcount")
    try:
        for i in range(plan.n_requests):
            n = 4 + i % 9
            out = fc.step(make_text(n, seed=i))
            if out.status == "fault":
                assert isinstance(out.value, ServiceCrashed), \
                    f"{out} — replay: {plan.describe()}"
    finally:
        gw.close()
    kills = [s for s in sessions
             if s._proc is not None and s._proc.exitcode == -signal.SIGKILL]
    assert len(kills) >= 2, \
        (f"crash faults fired but no service process died by SIGKILL "
         f"— replay: {plan.describe()}")
