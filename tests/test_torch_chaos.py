"""The reference's in-process chaos cases (``tests/test_chaos.py``) run
against the port's ``faultwire`` and gateway on the CPU, under their own
names, over the six in-process transports: (a) nothing hangs, (b) every
injected fault surfaces as its EXPECTED type (``FaultyClient`` raises
``FaultLeak`` otherwise), (c) an identical seed gives an identical outcome
sequence. Plus the typed-crash satellites, the engine service's recovery
and the gateway supervisor. The process transports' chaos cases are in
``tests/test_torch_chaos_proc.py``. On failure the printed
``FaultPlan.from_spec(...)`` line replays the run."""
import threading
import time

import numpy as np
import pytest
import torch

import torch_proc_handlers as H
from repro_torch.core import TRANSPORTS, ServiceGateway as _Gateway
from repro_torch.core.faultwire import (ALL_KINDS, EXPECTED, FaultFabric,
                                        FaultPlan, FaultyClient)
from repro_torch.core.transports import (HandlerCrash, MPKLinkOptTransport,
                                         ResponseTimeout, ServiceCrashed,
                                         ShmTransport)
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler

TIMEOUT = 0.4                      # transport response deadline under chaos
WALL_BUDGET = 60.0                 # hard per-run bound: nothing may hang


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """→ (outcome signature list, wall seconds, client). The signature is
    the deterministic fingerprint used by the replay test."""
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


@pytest.mark.parametrize("name", sorted(TRANSPORTS))
def test_chaos_all_kinds_bounded_and_typed(name):
    """(a)+(b): full-kind plan on every transport — bounded wall clock,
    correct types, and zero collateral failures on non-faulted requests."""
    plan = FaultPlan(seed=2024, n_requests=40, rate=0.25)
    sig, wall, fc = _run(name, plan)
    assert wall < WALL_BUDGET, f"hung? {wall}s — replay: {plan.describe()}"
    counts = fc.counts()
    assert counts["error"] == 0, \
        (f"non-faulted request failed: "
         f"{[s for s in sig if s[1] == 'error']} — replay: {plan.describe()}")
    assert counts["fault"] + counts["recovered"] == len(plan.events)
    for o in fc.outcomes:
        if o.status == "fault":
            assert isinstance(o.value, EXPECTED[o.kind]), \
                f"{o} — replay: {plan.describe()}"


@pytest.mark.parametrize("name", sorted(TRANSPORTS))
@pytest.mark.parametrize("kind", ALL_KINDS)
def test_chaos_single_kind(name, kind):
    """(b) per cell: one fault kind × one transport, ≥2 injections."""
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


@pytest.mark.parametrize("name", ["mpklink_opt", "pipe", "shm"])
def test_chaos_identical_seed_identical_outcomes(name):
    """(c): the fault schedule AND the outcome sequence are pure functions
    of (seed, plan) — two full runs fingerprint identically."""
    spec = FaultPlan(seed=777, n_requests=30, rate=0.3).spec()
    p1, p2 = FaultPlan.from_spec(spec), FaultPlan.from_spec(spec)
    assert [e for e in p1.schedule()] == [e for e in p2.schedule()]
    sig1, _, _ = _run(name, p1)
    sig2, _, _ = _run(name, p2)
    assert sig1 == sig2, f"nondeterministic — replay: {p1.describe()}"


def test_chaos_retries_heal_liveness_faults():
    """With bounded retries + idempotency tokens, liveness faults (crash/
    drop) are transparently healed: the answer is still correct and the
    handler is never double-executed for an already-completed request."""
    calls = []

    def counting(req):
        calls.append(1)
        return wordcount_handler(req)

    gw = ServiceGateway("mpklink_opt", transport_kwargs={"timeout": TIMEOUT})
    gw.register_service("wordcount", counting, factory=lambda: counting)
    gw.start()
    plan = FaultPlan(seed=5, n_requests=20, rate=0.3,
                     kinds=("drop_response", "crash_handler"))
    fab = FaultFabric(plan).attach(gw)
    fc = FaultyClient(gw.connect("healer", retries=3), fab, "wordcount")
    try:
        for i in range(plan.n_requests):
            n = 5 + i % 4
            out = fc.step(make_text(n, seed=i))
            assert out.ok, f"{out} — replay: {plan.describe()}"
            assert parse_count(out.value) == n
    finally:
        gw.close()
    n_drops = sum(1 for e in plan.events.values()
                  if e.kind == "drop_response")
    # dropped responses were answered from the dedup window on retry —
    # executed exactly once; only crashes (pre-execution kills) re-execute
    assert gw.stats["deduped"] == n_drops
    assert len(calls) == plan.n_requests


# ---------------------------------------------------------------------------
# "handler died" is typed, immediate — never a deadline stall
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [ShmTransport, MPKLinkOptTransport])
def test_session_crash_is_typed_and_immediate(cls):
    """A service thread that dies mid-request must surface ServiceCrashed
    at once — the client must NOT wait out the (long) response deadline."""
    def die(req):
        raise HandlerCrash("boom")

    tr = cls(die, timeout=30.0, device="cpu")
    tr.start()
    try:
        t0 = time.perf_counter()
        with pytest.raises(ServiceCrashed):
            tr.request(np.arange(4, dtype=np.uint8))
        elapsed = time.perf_counter() - t0
        assert elapsed < 5.0, f"sat out the deadline: {elapsed}s"
        # the dead session is refused immediately too (no new deadline wait)
        t0 = time.perf_counter()
        with pytest.raises(ServiceCrashed):
            tr._sessions[0].request(np.arange(4, dtype=np.uint8))
        assert time.perf_counter() - t0 < 1.0
        # ...and the transport-level API transparently reconnects; the new
        # session crashes again (same handler) but stays typed and fast
        with pytest.raises(ServiceCrashed):
            tr.request(np.arange(4, dtype=np.uint8))
    finally:
        tr.close()


def test_pipe_send_side_is_deadline_bounded():
    """A wedged service thread stops draining the request pipe; a large
    send must hit the deadline (typed), not block forever in os.write."""
    gate = threading.Event()

    def wedged(req):
        gate.wait(10)                   # stuck handler: pipe not drained
        return req

    tr = TRANSPORTS["pipe"](wedged, timeout=0.3, device="cpu")
    tr.start()
    s = tr.connect("w")
    try:
        first_err = []

        def occupy():                   # park the service thread in wedged()
            try:
                s.request(np.zeros(8, np.uint8))
            except Exception as e:
                first_err.append(e)

        t = threading.Thread(target=occupy, daemon=True)
        t.start()
        time.sleep(0.05)
        t0 = time.perf_counter()
        with pytest.raises(ResponseTimeout):
            # 1 MiB ≫ the pipe buffer: the send itself must be bounded
            s.request(np.zeros(1 << 20, np.uint8))
        assert time.perf_counter() - t0 < 5.0
    finally:
        gate.set()
        tr.close()


def test_timeout_vs_crash_are_distinct_types():
    """A slow handler is a ResponseTimeout; a dead handler is a
    ServiceCrashed — retry layers treat them differently."""
    def slow(req):
        time.sleep(0.5)
        return req

    tr = ShmTransport(slow, timeout=0.05, device="cpu")
    tr.start()
    try:
        with pytest.raises(ResponseTimeout):
            tr.request(np.arange(4, dtype=np.uint8))
    finally:
        tr.close()


# ---------------------------------------------------------------------------
# EngineService: a killed engine worker recovers mid-decode
# ---------------------------------------------------------------------------

def test_engine_service_recovers_from_midflight_crash():
    from repro_torch.core.transports import ServiceCrashed as SC
    from repro_torch.runtime import (EngineService, Request, encode_prompt,
                                     seeded_engine)

    engine = seeded_engine("llama3.2-1b", 0, max_batch=2, max_seq=32,
                           dtype="float32", device="cpu", reduced=True)
    svc = EngineService(engine, timeout=60.0).start()
    gw = ServiceGateway("mpklink_opt", transport_kwargs={"timeout": 60.0})
    gw.register_service("infer", svc.handler)
    gw.start()
    try:
        c = gw.connect("driver", retries=2)
        out = c.call("infer", encode_prompt([1, 2, 3], max_new=4))
        assert np.asarray(out).size == 4

        # kill the engine worker mid-decode: the in-flight request fails
        # typed + immediately, and the retrying client transparently
        # resubmits on the healed engine
        svc.inject_crash()
        out = c.call("infer", encode_prompt([4, 5], max_new=3))
        assert np.asarray(out).size == 3
        assert svc.crashes >= 1
        # engine keeps serving new work after the crash
        out = c.call("infer", encode_prompt([7], max_new=2))
        assert np.asarray(out).size == 2
    finally:
        gw.close()
        svc.close()

    # crash-recovery delivery semantics (unit, on an un-started service
    # sharing the same engine): work the dying tick already retired is
    # DELIVERED; queued/slotted work fails typed — nobody is stranded
    svc2 = EngineService(engine, timeout=5.0)
    finished = Request(rid=1, prompt=[1])
    finished.generated = [42]
    doomed = Request(rid=2, prompt=[2])
    ev1, ev2 = threading.Event(), threading.Event()
    svc2._events = {1: ev1, 2: ev2}
    engine.completed.append(finished)
    engine.queue.append(doomed)
    svc2._recover(RuntimeError("boom"))
    assert ev1.is_set() and ev2.is_set()
    assert svc2._done[1] is finished               # delivered, not dropped
    assert isinstance(svc2._failed[2], SC)
    assert svc2.crashes == 1 and engine.queue == []


# ---------------------------------------------------------------------------
# supervisor wiring: gateway health → heartbeat view → recovery plan
# ---------------------------------------------------------------------------

def test_gateway_supervisor_restarts_open_circuits():
    from repro_torch.runtime import GatewaySupervisor, plan_gateway_recovery

    healthy = {"a": {"state": "closed"}, "b": {"state": "open"},
               "c": {"state": "open"}, "d": {"state": "half_open"}}
    assert plan_gateway_recovery(healthy, {"b"}) == \
        [("restart", "b"), ("shed", "c"), ("probe", "d")]

    boom = {"n": 0}

    def flaky(req):
        boom["n"] += 1
        if boom["n"] <= 3:
            raise ValueError("flaky")
        return wordcount_handler(req)

    gw = ServiceGateway("uds")
    # no factory → the breaker opens instead of self-restarting inline;
    # the supervisor sweep is what heals it
    gw.register_service("wc", flaky, failure_threshold=3, probe_after=100)
    gw.start()
    sup = GatewaySupervisor(gw)
    try:
        c = gw.connect("x")
        for i in range(3):
            with pytest.raises(Exception):
                c.call("wc", make_text(4, seed=i))
        assert gw.health()["wc"]["state"] == "open"
        assert sup.observe()["wc"]["state"] == "open"
        assert "wc" not in sup.monitor.alive()
        gw._services["wc"].factory = lambda: flaky     # operator intervenes
        assert sup.heal() == [("restart", "wc")]
        assert gw.health()["wc"]["state"] == "closed"
        # epoch was bumped by the restart: the client re-keys transparently
        assert parse_count(c.call("wc", make_text(9, seed=9))) == 9
        assert "wc" in sup.monitor.alive() or sup.observe()["wc"]["state"] == "closed"
    finally:
        gw.close()
