"""The reference's in-process fleet cases (``tests/test_fleet.py``) run
against the port's ``ReplicaRouter`` / ``ServiceFleet`` on the CPU, under
their own names: seeded power-of-two routing, determinism and replay,
cohorts that never split, drain and join with one re-key each, and typed
unavailability; and the hedging cases of ``tests/test_retry_properties.py``
(late binding: one wire send, budget-capped). The cases over process
replicas (``test_fleet_proc_*``) and the scaling planner's are in
``tests/test_torch_fleet_proc.py``; here a ``*_proc`` name resolves to a
process replica and an unknown one is refused as in the reference."""
import functools
import os
import threading
import time

import numpy as np
import pytest
import torch

import torch_proc_handlers as H
from repro_torch.core import ALL_TRANSPORTS, procwire
from repro_torch.core.gateway import (FLEET_CHOICES, ReplicaRouter, RetryBudget,
                                      ServiceGateway as _ServiceGateway,
                                      simulate_assignments)
from repro_torch.core.transports import ServiceUnavailable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The gateway's tensors are tiny: one intra-op thread a worker keeps
    its latencies (which the routers and breakers act on) steady when the
    tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ServiceGateway(*args, **kw):
    """The port's gateway on the CPU (its default device is the card)."""
    kw.setdefault("device", "cpu")
    return _ServiceGateway(*args, **kw)


def _tagged(i):
    """Replica handler that appends its replica index to the payload —
    the child-side identity that proves where a request actually ran."""
    def handler(req):
        return np.concatenate([np.asarray(req, np.uint8),
                               np.array([i], np.uint8)])
    return handler


def _tag(out):
    return int(np.asarray(out)[-1])


# ---------------------------------------------------------------------------
# router: power-of-two choices, determinism, replay
# ---------------------------------------------------------------------------

def test_router_skew_bounded():
    """Power-of-two + least-loaded keeps per-replica assignment counts
    near-uniform at full load: no replica gets starved or doubled."""
    n, total = 4, 2000
    picks = simulate_assignments(0xBEEF, [i * 1.0 for i in range(total)],
                                 n, 4.0)
    counts = [picks.count(rid) for rid in range(n)]
    mean = total / n
    assert min(counts) > 0.7 * mean, counts
    assert max(counts) < 1.3 * mean, counts


def test_router_skew_beats_single_choice():
    """The '2' in power-of-two is load-bearing: with choices=1 (pure
    random) the max/min spread is measurably worse than with choices=2 on
    the identical arrival trace."""
    arrivals = [i * 1.0 for i in range(2000)]

    def spread(choices):
        picks = simulate_assignments(7, arrivals, 4, 4.0, choices=choices)
        counts = [picks.count(r) for r in range(4)]
        return max(counts) - min(counts)

    assert spread(2) < spread(1), (spread(2), spread(1))


@pytest.mark.parametrize("seed", [0, 1, 7, 0xDEADBEEF])
def test_router_determinism_property(seed):
    """Identical (seed, arrival trace) → identical replica assignment
    sequence — the FaultPlan property that makes a fleet imbalance
    reproduce from a one-line seed."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0, size=300)).tolist()
    svc = rng.uniform(0.5, 6.0, size=300).tolist()
    a = simulate_assignments(seed, arrivals, 3, svc)
    b = simulate_assignments(seed, arrivals, 3, svc)
    assert a == b
    # a different seed almost surely routes differently on a 300-long trace
    assert a != simulate_assignments(seed + 1, arrivals, 3, svc)


def test_router_trace_replay():
    """A recorded decision trace replays bit-for-bit from a fresh router
    with the same seed; a tampered pick is caught loudly."""
    r = ReplicaRouter(0x5EED, record=True)
    rng = np.random.default_rng(3)
    for _ in range(200):
        loads = [(rid, int(rng.integers(0, 5)), float(rng.uniform(0, 4)))
                 for rid in range(5)]
        r.pick(loads)
    assert r.replay(r.trace) == [t[2] for t in r.trace]
    bad = list(r.trace)
    loads, cands, picked = bad[57]
    other = next(rid for rid, _, _ in loads if rid != picked)
    bad[57] = (loads, cands, other)
    with pytest.raises(AssertionError, match="decision 57"):
        r.replay(bad)


def test_router_candidates_distinct_and_least_loaded():
    r = ReplicaRouter(1, record=True)
    for _ in range(100):
        # rid 2 is always strictly least-loaded: whenever it is drawn it
        # must win; candidates must always be distinct
        r.pick([(0, 5, 9.0), (1, 5, 9.0), (2, 0, 0.1), (3, 5, 9.0)])
    for loads, cands, picked in r.trace:
        assert len(cands) == len(set(cands)) == FLEET_CHOICES
        if 2 in cands:
            assert picked == 2
    assert r.picks == 100 and sum(r.assigned.values()) == 100


def test_router_single_replica_and_empty():
    r = ReplicaRouter(0)
    assert r.pick([(9, 3, 1.0)]) == 9
    with pytest.raises(ServiceUnavailable):
        r.pick([])


def test_simulate_service_time_vector_validation():
    with pytest.raises(ValueError):
        simulate_assignments(0, [0.0, 1.0, 2.0], 2, [1.0, 2.0])


# ---------------------------------------------------------------------------
# elastic scaling policy (pure decision)
# ---------------------------------------------------------------------------

def _snap(rid, state, inflight=0, ewma=1.0):
    return {"rid": rid, "state": state, "inflight": inflight,
            "ewma_ms": ewma, "served": 0, "crashes": 0}


# ---------------------------------------------------------------------------
# in-process fleet: routing, cohort wholeness, drain/join (tier-1 fast)
# ---------------------------------------------------------------------------

def _inproc_fleet(n=3, **replica_kw):
    gw = ServiceGateway("mpklink_opt")
    for i in range(n):
        gw.register_replica("echo", _tagged(i), transport="mpklink_opt",
                            **replica_kw)
    return gw.start()


def test_fleet_routes_across_replicas():
    gw = _inproc_fleet(3)
    try:
        cli = gw.connect("c0")
        seen = set()
        for _ in range(40):
            out = cli.call("echo", np.arange(4, dtype=np.uint8))
            assert np.asarray(out)[:4].tolist() == [0, 1, 2, 3]
            seen.add(_tag(out))
        assert len(seen) >= 2, seen
        snap = gw.fleet_stats()["echo"]
        assert sum(s["served"] for s in snap) == 40
        assert all(s["state"] == "active" and s["inflight"] == 0
                   for s in snap)
        cli.close()
    finally:
        gw.close()


def test_fleet_cohorts_never_split():
    """A batch envelope lands WHOLE on one replica — every item of every
    cohort carries the same replica tag, across many cohorts."""
    gw = _inproc_fleet(3)
    try:
        cli = gw.connect("c0")
        tags_per_cohort = []
        for k in range(12):
            outs = cli.call_batch("echo",
                                  [np.arange(3, dtype=np.uint8)] * (4 + k))
            tags = {_tag(o) for o in outs}
            assert len(tags) == 1, f"cohort {k} split across replicas {tags}"
            tags_per_cohort.append(tags.pop())
        assert len(set(tags_per_cohort)) >= 2, tags_per_cohort
        assert gw.fleet("echo").stats["cohorts"] == 12
        cli.close()
    finally:
        gw.close()


def test_fleet_coalesced_cohorts_never_split():
    """Auto-coalesced inline calls (the mux's scatter cohort) reach the
    fleet through the same batch path and stay on one replica per
    cohort."""
    gw = _inproc_fleet(3)
    gw.enable_coalescing(max_wait_us=2000.0)
    try:
        clients = [gw.connect(f"c{i}") for i in range(8)]
        results = [None] * 8
        start = threading.Barrier(8)

        def caller(i):
            start.wait()
            results[i] = clients[i].call("echo",
                                         np.arange(2, dtype=np.uint8))

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None for r in results)
        tags = {_tag(r) for r in results}
        fleet = gw.fleet("echo")
        # every admission unit (coalesced cohort or single call) stayed
        # whole: one routing decision = one replica, so the distinct
        # replica tags observed can never exceed the router's pick count
        assert len(tags) <= fleet.router.picks
        assert fleet.stats["routed"] == 8
        for c in clients:
            c.close()
    finally:
        gw.close()


def test_fleet_drain_then_join_rekeys_once():
    """Drain: the drained replica quiesces and never serves again; join:
    the service-domain epoch bumps exactly ONCE and traffic continues
    (clients transparently re-key on their next call)."""
    gw = _inproc_fleet(2)
    try:
        cli = gw.connect("c0")
        for _ in range(10):
            cli.call("echo", np.arange(2, dtype=np.uint8))
        svc = gw._services["echo"]
        epoch0 = gw.registry.epoch(svc.domain)
        assert gw.drain_replica("echo", 0, timeout=10.0)
        assert gw.registry.epoch(svc.domain) == epoch0 + 1
        snap = {s["rid"]: s for s in gw.fleet_stats()["echo"]}
        assert snap[0]["state"] == "quiesced"
        for _ in range(10):
            assert _tag(cli.call("echo", np.arange(2, dtype=np.uint8))) == 1
        # join under live traffic: one more epoch bump, then the new
        # replica joins the routing set
        epoch1 = gw.registry.epoch(svc.domain)
        rid = gw.register_replica("echo", _tagged(7),
                                  transport="mpklink_opt")
        assert gw.registry.epoch(svc.domain) == epoch1 + 1
        seen = set()
        for _ in range(40):
            seen.add(_tag(cli.call("echo", np.arange(2, dtype=np.uint8))))
        assert seen == {1, 7}, seen
        assert rid == 2
        cli.close()
    finally:
        gw.close()


def test_fleet_and_plain_service_names_do_not_mix():
    gw = ServiceGateway("mpklink_opt")
    try:
        gw.register_service("plain", _tagged(0))
        with pytest.raises(ValueError, match="plain"):
            gw.register_replica("plain", _tagged(1))
        with pytest.raises(KeyError):
            gw.fleet("nope")
    finally:
        gw.close()


def test_fleet_all_replicas_gone_is_typed_unavailable():
    gw = _inproc_fleet(1)
    try:
        cli = gw.connect("c0")
        cli.call("echo", np.arange(2, dtype=np.uint8))
        assert gw.drain_replica("echo", 0, timeout=10.0)
        with pytest.raises(ServiceUnavailable):
            cli.call("echo", np.arange(2, dtype=np.uint8))
        cli.close()
    finally:
        gw.close()


@pytest.mark.proc
def test_proc_transport_names_refused_typed():
    """Every name of the reference's ``PROC_TRANSPORTS`` and
    ``BASELINE_TRANSPORTS`` resolves; the default transport of
    ``register_replica`` is a process replica (its handler answers from a
    child process); and an unknown name is refused with the reference's
    ``KeyError``, by a fleet and by a gateway alike."""
    from repro.core import BASELINE_TRANSPORTS, PROC_TRANSPORTS
    assert set(PROC_TRANSPORTS) | set(BASELINE_TRANSPORTS) \
        <= set(ALL_TRANSPORTS)
    gw = ServiceGateway("mpklink_opt")
    try:
        rid = gw.register_replica("echo", functools.partial(H.tagged, 0),
                                  transport_kwargs={"timeout": 30.0})
        rep = gw.fleet("echo")._replicas[rid]
        assert isinstance(rep.transport, procwire.ProcMPKLinkOptTransport)
        cli = gw.connect("c0")
        assert _tag(cli.call("echo", np.arange(2, dtype=np.uint8))) == 0
        assert rep.session._proc.pid != os.getpid()
        assert rep.session._proc.is_alive()
        cli.close()
        with pytest.raises(KeyError):
            gw.register_replica("echo", _tagged(0), transport="uds_proc")
    finally:
        gw.close()
    with pytest.raises(KeyError):
        ServiceGateway("uds_proc")


# the hedging cases of tests/test_retry_properties.py (no faultwire needed)
# ---------------------------------------------------------------------------
# hedging: late binding — one wire send ever, budget-capped
# ---------------------------------------------------------------------------

def _tagged_counting(i, counts, lock):
    def handler(req):
        with lock:
            counts[i] = counts.get(i, 0) + 1
        return np.concatenate([np.asarray(req, np.uint8),
                               np.array([i], np.uint8)])
    return handler


def _hedge_fleet(n=2):
    counts, lock = {}, threading.Lock()
    gw = ServiceGateway("mpklink_opt")
    for i in range(n):
        gw.register_replica("echo", _tagged_counting(i, counts, lock),
                            transport="mpklink_opt")
    return gw.start(), counts


def test_hedge_fires_once_and_executes_once():
    """Both replicas' wire locks held → the parked request hedges to the
    other replica after the delay, completes there when released, and the
    handler population executed EXACTLY once (late binding: the hedge
    re-routes before any send)."""
    gw, counts = _hedge_fleet(2)
    fleet = gw.fleet("echo")
    budget = fleet.enable_hedging(delay=0.05)
    try:
        for rep in fleet._replicas.values():
            assert rep.rlock.acquire(timeout=1.0)
        cli = gw.connect("c0")
        result = {}

        def caller():
            result["out"] = cli.call("echo", np.arange(4, dtype=np.uint8))

        t = threading.Thread(target=caller)
        t.start()
        time.sleep(0.4)                 # well past the hedge delay
        assert fleet.stats["hedges_fired"] == 1
        for rep in fleet._replicas.values():
            rep.rlock.release()
        t.join(timeout=10)
        assert np.asarray(result["out"])[:4].tolist() == [0, 1, 2, 3]
        assert sum(counts.values()) == 1
        assert fleet.stats["hedges_won"] == 1
        assert budget.spent == 1
        cli.close()
    finally:
        for rep in fleet._replicas.values():
            try:
                rep.rlock.release()
            except RuntimeError:
                pass
        gw.close()


def test_hedge_respects_dry_budget():
    """Bucket empty → the parked request waits like an unhedged one;
    zero hedges fire and the refusal is counted."""
    gw, counts = _hedge_fleet(2)
    fleet = gw.fleet("echo")
    budget = fleet.enable_hedging(
        delay=0.05, budget=RetryBudget(ratio=0.0, burst=1, initial=0.0))
    try:
        for rep in fleet._replicas.values():
            assert rep.rlock.acquire(timeout=1.0)
        cli = gw.connect("c0")
        result = {}

        def caller():
            result["out"] = cli.call("echo", np.arange(4, dtype=np.uint8))

        t = threading.Thread(target=caller)
        t.start()
        time.sleep(0.4)
        assert fleet.stats["hedges_fired"] == 0
        assert budget.denied >= 1
        for rep in fleet._replicas.values():
            rep.rlock.release()
        t.join(timeout=10)
        assert np.asarray(result["out"])[:4].tolist() == [0, 1, 2, 3]
        assert sum(counts.values()) == 1
        cli.close()
    finally:
        for rep in fleet._replicas.values():
            try:
                rep.rlock.release()
            except RuntimeError:
                pass
        gw.close()


def test_hedge_load_single_execution_per_request():
    """Concurrent clients against slow replicas with hedging on: every
    request executes exactly once fleet-wide (sum of handler executions
    == completed requests) and hedge spend stays within the bucket."""
    counts, lock = {}, threading.Lock()

    def slow_counting(i):
        def handler(req):
            with lock:
                counts[bytes(np.asarray(req, np.uint8).tobytes())] = \
                    counts.get(bytes(np.asarray(req, np.uint8).tobytes()),
                               0) + 1
            time.sleep(0.02)
            return np.asarray(req, np.uint8)
        return handler

    gw = ServiceGateway("mpklink_opt")
    for i in range(2):
        gw.register_replica("echo", slow_counting(i),
                            transport="mpklink_opt")
    gw.start()
    fleet = gw.fleet("echo")
    budget = fleet.enable_hedging(delay=0.01,
                                  budget=RetryBudget(ratio=1.0, burst=64,
                                                     initial=64))
    try:
        n_clients, reps = 6, 5
        errors = []

        def worker(i):
            try:
                c = gw.connect(f"c{i}")
                for j in range(reps):
                    payload = np.array([i, j, i + j], np.uint8)
                    out = c.call("echo", payload)
                    np.testing.assert_array_equal(np.asarray(out), payload)
                c.close()
            except Exception as e:      # pragma: no cover - surfaced below
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert all(v == 1 for v in counts.values()), \
            {k: v for k, v in counts.items() if v > 1}
        assert len(counts) == n_clients * reps
        assert budget.spent == fleet.stats["hedges_fired"]
        assert budget.spent <= 64
    finally:
        gw.close()
