"""The reference's fault-injection cases that need ``faultwire`` and were
left out of the gateway ports, run against the port on the CPU under their
own names: the coalescer under the 8 fault kinds
(``tests/test_coalescer.py``: ``test_chaos_*``,
``test_dropped_cohort_response_never_double_executes``,
``test_crashed_cohort_recovers_per_item``), a crash mid batch envelope
(``tests/test_batching.py``), and the retry-budget properties under every
fault kind and under a real ``kill -9`` of a replica process
(``tests/test_retry_properties.py``; its hedge cases are in
``tests/test_torch_gateway_fleet.py``)."""
import functools
import os
import signal
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import torch_proc_handlers as H
from repro_torch.core import ServiceGateway as _Gateway, framing
from repro_torch.core.domains import AccessViolation
from repro_torch.core.faultwire import (ALL_KINDS, CLIENT_KINDS, EXPECTED,
                                        FaultFabric, FaultPlan, FaultyClient)
from repro_torch.core.gateway import RetryBudget
from repro_torch.core.transports import ServiceCrashed, TransportError
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler

WALL_BUDGET = 90.0                  # the coalescer cases' bound
TIME_BUDGET = 10.0                  # the batch crash case's bound
TIMEOUT = 0.4
_PROC_KW = {"ring_slots": 2, "timeout": 30.0}


@pytest.fixture(autouse=True, scope="module")
def _port_proc_hygiene(request):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    H.proc_hygiene(request.module.__name__)


@pytest.fixture(autouse=True)
def _bounded():
    with H.bounded(150):
        yield


def ServiceGateway(*args, **kw):
    kw.setdefault("device", "cpu")
    return _Gateway(*args, **kw)


# ---------------------------------------------------------------------------
# the coalescer under faults
# ---------------------------------------------------------------------------

def _mux_gateway(transport="mpklink_opt", *, timeout=30.0, factory=True,
                 max_batch=32, max_wait_us=400.0, **svc_kw):
    gw = ServiceGateway(transport, max_keys=512,
                        transport_kwargs={"timeout": timeout})
    gw.register_service(
        "wordcount", wordcount_handler,
        factory=H.wordcount_factory if factory else None, **svc_kw)
    gw.start()
    mux = gw.enable_coalescing(max_batch=max_batch, max_wait_us=max_wait_us)
    return gw, mux


def _hammer(gw, n_clients, reps, payload_fn=None, service="wordcount"):
    """n_clients threads, each its own GatewayClient, all calling inline
    through the mux. Returns (results per (i, j), error list)."""
    clients = [gw.connect(f"co-{i}") for i in range(n_clients)]
    for c in clients:
        c.open(service)
    results: dict = {}
    errors: list = []
    barrier = threading.Barrier(n_clients)

    def worker(i):
        try:
            barrier.wait()
            for j in range(reps):
                p = payload_fn(i, j) if payload_fn \
                    else make_text(3 + (i + j) % 7, seed=i * 131 + j)
                results[(i, j)] = clients[i].call(service, p)
        except Exception as e:
            errors.append((i, e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WALL_BUDGET)
    return clients, results, errors


def test_dropped_cohort_response_never_double_executes():
    """drop_response on a cohort envelope: every item already executed, so
    the mux's same-token inline replay is answered from the dedup window —
    the handler runs each request exactly once."""
    calls = []

    def counting(req):
        calls.append(1)
        return wordcount_handler(req)

    gw = ServiceGateway("mpklink_opt", max_keys=512,
                        transport_kwargs={"timeout": 0.4})
    gw.register_service("wordcount", counting,
                        factory=lambda: counting)
    gw.start()
    mux = gw.enable_coalescing(max_batch=16, max_wait_us=300.0)
    plan = FaultPlan(seed=11, n_requests=24, rate=0.2,
                     kinds=("drop_response",))
    fab = FaultFabric(plan).attach(gw)
    try:
        c = gw.connect("dropper")
        c.open("wordcount")
        t0 = time.perf_counter()
        for j in range(plan.n_requests):
            n = 4 + j % 5
            assert parse_count(c.call("wordcount",
                                      make_text(n, seed=j))) == n
        wall = time.perf_counter() - t0
        assert wall < WALL_BUDGET
        n_drops = len([e for e in fab.fired if e.kind == "drop_response"])
        assert n_drops >= 1, "plan fired no drops — test is vacuous"
        assert len(calls) == plan.n_requests, \
            f"{len(calls)} executions for {plan.n_requests} requests"
        # every drop (cohort envelope OR replay) is answered from the dedup
        # window exactly once downstream; replays that were themselves
        # dropped ride the carrier's bounded retry within one fallback item
        assert gw.stats["deduped"] == n_drops
        assert mux.stats["fallback_items"] >= 1
    finally:
        fab.detach()
        gw.close()


def test_crashed_cohort_recovers_per_item():
    """crash_handler kills the carrier's session mid-envelope (before any
    handler ran): the mux heals and replays inline — every caller still
    gets its correct answer, typed and bounded."""
    gw, mux = _mux_gateway(timeout=0.4)
    plan = FaultPlan(seed=7, n_requests=20, rate=0.2,
                     kinds=("crash_handler",))
    fab = FaultFabric(plan).attach(gw)
    try:
        clients, results, errors = _hammer(gw, 6, 4)
        assert not errors, errors[:3]
        for (i, j), out in results.items():
            assert parse_count(out) == 3 + (i + j) % 7
        assert len(fab.fired) >= 1
        assert mux.stats["fallback_items"] >= 1
    finally:
        fab.detach()
        gw.close()


def test_chaos_all_kinds_through_the_coalescer():
    """Full-kind FaultPlan with the mux on and concurrent cohort traffic:
    injected security faults surface as their EXPECTED types (FaultyClient
    raises FaultLeak otherwise), liveness faults heal per item, background
    cohort-mates keep completing correctly, and the whole run is bounded."""
    gw, mux = _mux_gateway(timeout=0.4)
    plan = FaultPlan(seed=2026, n_requests=30, rate=0.25)
    fab = FaultFabric(plan).attach(gw)
    stop = threading.Event()
    bg_errors: list = []
    bg_done = {"n": 0}

    def background(i):
        c = gw.connect(f"bg-{i}")
        c.open("wordcount")
        j = 0
        while not stop.is_set():
            n = 3 + (i + j) % 6
            try:
                out = c.call("wordcount", make_text(n, seed=i * 997 + j))
                assert parse_count(out) == n
                bg_done["n"] += 1
            except (TransportError, AccessViolation,
                    framing.FrameError):
                c.heal("wordcount")     # typed: heal and keep hammering
            j += 1

    threads = [threading.Thread(target=background, args=(i,), daemon=True)
               for i in range(4)]
    for t in threads:
        t.start()
    fc = FaultyClient(gw.connect("chaos-co"), fab, "wordcount")
    t0 = time.perf_counter()
    try:
        for i in range(plan.n_requests):
            n = 4 + i % 9
            out = fc.step(make_text(n, seed=i))
            if out.status == "ok":
                assert parse_count(out.value) == n, \
                    f"wrong answer at {i} — replay: {plan.describe()}"
    finally:
        stop.set()
        wall = time.perf_counter() - t0
        for t in threads:
            t.join(10.0)
        fab.detach()
        gw.close()
    assert wall < WALL_BUDGET, f"hung? {wall}s — replay: {plan.describe()}"
    assert bg_done["n"] > 0, "background cohort traffic never completed"
    # every injected client-side fault surfaced as its EXPECTED type (the
    # server kinds may heal transparently through the mux — that is the
    # coalescer's liveness fallback doing its job)
    for o in fc.outcomes:
        if o.status == "fault" and o.kind in CLIENT_KINDS:
            assert isinstance(o.value, EXPECTED[o.kind]), \
                f"{o} — replay: {plan.describe()}"
        # nothing may escape the typed taxonomy
        if isinstance(o.value, BaseException):
            assert isinstance(o.value, (TransportError, AccessViolation,
                                        framing.FrameError)), \
                f"untyped escape {o} — replay: {plan.describe()}"


@pytest.mark.parametrize("kind", ["corrupt_mac", "truncate", "reorder_seq",
                                  "stale_replay", "forge_identity",
                                  "crash_handler", "drop_response",
                                  "delay_response"])
def test_chaos_single_kind_through_the_coalescer(kind):
    """Each fault kind alone, with the mux enabled: typed and bounded."""
    gw, mux = _mux_gateway(timeout=0.4)
    plan = FaultPlan(seed=hash(("co", kind)) & 0xFFFF, n_requests=12,
                     rate=0.25, kinds=(kind,))
    assert len(plan.events) >= 2
    fab = FaultFabric(plan).attach(gw)
    fc = FaultyClient(gw.connect("chaos-one"), fab, "wordcount")
    t0 = time.perf_counter()
    try:
        for i in range(plan.n_requests):
            n = 4 + i % 7
            out = fc.step(make_text(n, seed=i))
            if out.status == "ok":
                assert parse_count(out.value) == n
    finally:
        wall = time.perf_counter() - t0
        fab.detach()
        gw.close()
    assert wall < WALL_BUDGET, f"hung? — replay: {plan.describe()}"
    expected = EXPECTED[kind]
    for o in fc.outcomes:
        if o.kind != kind or o.status != "fault":
            continue
        if kind in CLIENT_KINDS:
            assert isinstance(o.value, expected), \
                f"{o} — replay: {plan.describe()}"
        elif expected is not None:
            # server kinds may heal transparently through the mux; when
            # they DO surface, the type must be the taxonomy's
            assert isinstance(o.value, (expected, TransportError)), \
                f"{o} — replay: {plan.describe()}"


# ---------------------------------------------------------------------------
# a crash mid batch envelope
# ---------------------------------------------------------------------------

def test_gateway_batch_crash_handler_mid_batch_typed_and_bounded():
    """faultwire crash_handler fired while a batch envelope is in flight:
    the client gets ONE typed ServiceCrashed immediately (no deadline
    stall), and a healed client resumes batching."""
    gw = ServiceGateway("mpklink_opt",
                        transport_kwargs={"timeout": TIME_BUDGET * 3})
    gw.register_service("wordcount", wordcount_handler)
    gw.start()
    plan = FaultPlan(seed=99, n_requests=4, rate=0.25,
                     kinds=("crash_handler",))
    [ev] = plan.schedule()
    fabric = FaultFabric(plan).attach(gw)
    t0 = time.monotonic()
    try:
        c = gw.connect("b")
        ns = [3, 4]
        for idx in range(4):
            if idx == ev.index:
                with pytest.raises(ServiceCrashed):
                    c.call_batch("wordcount",
                                 [make_text(n, seed=n) for n in ns])
                c.heal("wordcount")
            else:
                outs = c.call_batch("wordcount",
                                    [make_text(n, seed=n) for n in ns])
                assert [parse_count(o) for o in outs] == ns
        assert [e.kind for e in fabric.fired] == ["crash_handler"]
    finally:
        fabric.detach()
        gw.close()
    assert time.monotonic() - t0 < TIME_BUDGET


# ---------------------------------------------------------------------------
# retry budget and single execution under every fault kind
# ---------------------------------------------------------------------------

def _counting_gateway():
    """Gateway whose wordcount handler counts executions PER PAYLOAD —
    the ground truth for the no-double-execution property."""
    counts = {}
    lock = threading.Lock()

    def counting(req):
        key = H.host(req).tobytes()
        with lock:
            counts[key] = counts.get(key, 0) + 1
        return wordcount_handler(req)

    gw = ServiceGateway("mpklink_opt", transport_kwargs={"timeout": TIMEOUT})
    gw.register_service("wordcount", counting, factory=lambda: counting)
    return gw.start(), counts


def _run_plan(plan, *, retries=3, budget=None):
    gw, counts = _counting_gateway()
    fab = FaultFabric(plan).attach(gw)
    fc = FaultyClient(gw.connect("prop-client", retries=retries,
                                 retry_budget=budget), fab, "wordcount")
    t0 = time.perf_counter()
    try:
        for i in range(plan.n_requests):
            n = 4 + i % 9
            out = fc.step(make_text(n, seed=i))
            if out.status == "ok":
                assert parse_count(out.value) == n, \
                    f"wrong answer at {i} — replay: {plan.describe()}"
    finally:
        wall = time.perf_counter() - t0
        gw.close()
    sig = [(o.index, o.status, o.kind, type(o.value).__name__)
           for o in fc.outcomes]
    return sig, wall, counts, fc


# ---------------------------------------------------------------------------
# the two core properties, per fault kind
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ALL_KINDS)
def test_budget_and_single_execution_per_kind(kind):
    """For every fault kind: (1) no payload ever executes more than once
    — dedup answers retried duplicates from the window; (2) extra
    attempts stay within the token bucket's mathematical bound
    ``initial + ratio × primaries``; (3) the run is wall-bounded."""
    # NOT hash(): builtin hash is salted per process (PYTHONHASHSEED), and
    # an unlucky plan can drift a server-side drop onto a non-faulted wire
    # index once retries shift the schedule — the seed must be stable
    plan = FaultPlan(seed=(zlib.crc32(kind.encode()) + 3) & 0xFFFF,
                     n_requests=24, rate=0.25, kinds=(kind,))
    assert len(plan.events) >= 2
    budget = RetryBudget(ratio=0.25, burst=3)
    sig, wall, counts, fc = _run_plan(plan, budget=budget)
    assert wall < WALL_BUDGET, f"hung? — replay: {plan.describe()}"
    over = {k: v for k, v in counts.items() if v > 1}
    assert not over, \
        f"double-executed under {kind}: {len(over)} payloads — " \
        f"replay: {plan.describe()}"
    allowance = 3 + 0.25 * plan.n_requests
    assert budget.spent <= allowance, (budget.spent, allowance)
    assert fc.counts()["error"] == 0, f"replay: {plan.describe()}"


def test_budget_and_single_execution_full_matrix():
    """All 8 kinds interleaved in one seeded run — the properties hold
    jointly, not just per-kind."""
    plan = FaultPlan(seed=0x90B, n_requests=48, rate=0.3)
    budget = RetryBudget(ratio=0.25, burst=3)
    sig, wall, counts, fc = _run_plan(plan, budget=budget)
    assert wall < WALL_BUDGET
    assert all(v <= 1 for v in counts.values()), \
        f"replay: {plan.describe()}"
    assert budget.spent <= 3 + 0.25 * plan.n_requests
    assert fc.counts()["error"] == 0, f"replay: {plan.describe()}"


def test_dry_budget_means_zero_extra_attempts():
    """With an empty bucket the client may not retry at all, whatever
    ``retries`` says: executions ≤ primaries, spend stays zero, and the
    refusals are counted."""
    plan = FaultPlan(seed=0xD0, n_requests=24, rate=0.3,
                     kinds=("drop_response", "crash_handler"))
    budget = RetryBudget(ratio=0.0, burst=1, initial=0.0)
    sig, wall, counts, fc = _run_plan(plan, budget=budget)
    assert budget.spent == 0
    assert budget.denied >= 1
    assert sum(counts.values()) <= plan.n_requests
    assert all(v <= 1 for v in counts.values())


def test_identical_seed_identical_outcomes_and_spend():
    """Seeded determinism extends to the budget: two runs of the same
    plan fingerprint identically AND spend identically."""
    spec = FaultPlan(seed=424, n_requests=30, rate=0.3).spec()
    b1 = RetryBudget(ratio=0.25, burst=3)
    b2 = RetryBudget(ratio=0.25, burst=3)
    sig1, _, _, _ = _run_plan(FaultPlan.from_spec(spec), budget=b1)
    sig2, _, _, _ = _run_plan(FaultPlan.from_spec(spec), budget=b2)
    assert sig1 == sig2
    assert (b1.spent, b1.denied) == (b2.spent, b2.denied)


@pytest.mark.proc
def test_kill9_no_lost_no_double_budget_bounded():
    """kill -9 a live replica mid-traffic: every request either succeeds
    (correct answer) or fails TYPED; each success executed on exactly one
    replica (sum of served == successes); client retry spend stays within
    the bucket."""
    gw = ServiceGateway("mpklink_opt")
    for i in range(2):
        gw.register_replica("echo", functools.partial(H.tagged, i),
                            transport_kwargs=_PROC_KW)
    gw.start()
    fleet = gw.fleet("echo")
    budget = RetryBudget(ratio=0.25, burst=3)
    try:
        cli = gw.connect("c0", retries=3, retry_budget=budget)
        warm = 0
        while not all(r.session._proc is not None
                      for r in fleet._replicas.values()):
            cli.call("echo", np.arange(4, dtype=np.uint8))
            warm += 1
            assert warm < 100, "fleet never warmed"
        victim = next(r for r in fleet._replicas.values()
                      if r.session._proc is not None)
        os.kill(victim.session._proc.pid, signal.SIGKILL)
        ok = 0
        n = 40
        for k in range(n):
            try:
                out = cli.call("echo", np.arange(4, dtype=np.uint8))
            except Exception as e:
                # typed liveness failure only — never silence, never hang
                assert isinstance(e, TransportError), repr(e)
            else:
                assert H.host(out)[:4].tolist() == [0, 1, 2, 3]
                ok += 1
        served = sum(r.served for r in fleet._replicas.values())
        assert served == warm + ok, (served, warm, ok)
        assert budget.spent <= 3 + 0.25 * (warm + n)
        assert ok >= n // 2, f"only {ok}/{n} healed"
        cli.close()
    finally:
        gw.close()
