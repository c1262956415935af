"""The reference's ``FleetSupervisor`` cases (``tests/test_supervisor.py``)
run against the port on the CPU, under their own names: the outlier
ejection planner, the supervisor over an in-process fleet, and over
process replicas with real ``kill -9``; plus the three planners of
``runtime.elastic`` held against the reference's on the same snapshots,
fixed and hypothesis-drawn (equal action lists). The reference's
``_tagged`` closures are ``functools.partial(torch_proc_handlers.tagged,
i)`` (process replicas pickle their handler)."""
import functools
import os
import signal
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_proc_handlers as H
from repro.runtime import elastic as ref_elastic
from repro_torch.core.gateway import (REPLICA_ACTIVE, REPLICA_DEAD,
                                      FleetSupervisor,
                                      ServiceGateway as _Gateway)
from repro_torch.runtime import elastic
from repro_torch.runtime.elastic import (plan_fleet_scaling,
                                         plan_outlier_ejection)

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
    with H.bounded(120):
        yield


def ServiceGateway(*args, **kw):
    kw.setdefault("device", "cpu")
    return _Gateway(*args, **kw)


def _tagged(i):
    return functools.partial(H.tagged, i)


def _tag(out):
    return int(H.host(out)[-1])


def _snap(rid, state="active", ewma=5.0, served=100, inflight=0):
    return {"rid": rid, "state": state, "ewma_ms": ewma,
            "served": served, "inflight": inflight}


# ---------------------------------------------------------------------------
# plan_outlier_ejection: pure policy, guard rails
# ---------------------------------------------------------------------------

def test_ejection_flags_the_slow_replica():
    snap = [_snap(0), _snap(1), _snap(2), _snap(3, ewma=40.0)]
    assert plan_outlier_ejection(snap, factor=4.0) == [("eject", 3)]


def test_ejection_peer_median_excludes_self():
    """One giant outlier cannot drag the median up past itself: with
    peers at 5ms the 500ms replica is ejected even though the median OF
    ALL FOUR would include its own value."""
    snap = [_snap(0), _snap(1), _snap(2), _snap(3, ewma=500.0)]
    assert plan_outlier_ejection(snap) == [("eject", 3)]


def test_ejection_needs_min_peers():
    """Two replicas are not a population — neither can be an outlier of
    the other."""
    snap = [_snap(0), _snap(1, ewma=500.0)]
    assert plan_outlier_ejection(snap, min_peers=3) == []


def test_ejection_spares_warming_replicas():
    """A replica below min_served keeps its EWMA grace period: warmup
    noise (cold caches, lazy fork) must not read as pathology."""
    snap = [_snap(0), _snap(1), _snap(2),
            _snap(3, ewma=500.0, served=5)]
    assert plan_outlier_ejection(snap, min_served=32) == []


def test_ejection_ignores_non_active_and_unobserved():
    snap = [_snap(0), _snap(1), _snap(2, ewma=None),
            _snap(3, state="dead", ewma=900.0),
            _snap(4, state="draining", ewma=900.0)]
    assert plan_outlier_ejection(snap) == []


def test_ejection_orders_by_rid():
    snap = [_snap(5, ewma=90.0), _snap(0), _snap(1), _snap(2),
            _snap(3, ewma=80.0)]
    assert plan_outlier_ejection(snap) == [("eject", 3), ("eject", 5)]


# ---------------------------------------------------------------------------
# supervisor over an in-process fleet (tier-1)
# ---------------------------------------------------------------------------

def _inproc_fleet(n=3):
    gw = ServiceGateway("mpklink_opt")
    for i in range(n):
        gw.register_replica("echo", _tagged(i), transport="mpklink_opt")
    return gw.start()


def test_supervisor_steady_state_is_a_no_op():
    """A healthy fleet at target: probes come back alive, every sweep's
    plan is empty, nothing is respawned, and the trace replays."""
    gw = _inproc_fleet(3)
    sup = FleetSupervisor(gw, "echo", target=3, record=True)
    try:
        for _ in range(3):
            assert sup.sweep() == []
        assert sup.stats["sweeps"] == 3
        assert sup.stats["probes"] == 9
        assert sup.stats["respawns"] == sup.stats["deaths_detected"] == 0
        assert all(v == "alive" for _, probes, _, _ in sup.trace
                   for _, v in probes)
        sup.replay()
    finally:
        gw.close()


def test_supervisor_resurrects_a_dead_replica():
    """A DEAD replica is released (one re-key) and a fresh one joins from
    the fleet's spawn spec — capacity returns to target in one sweep and
    traffic lands on the resurrected set."""
    gw = _inproc_fleet(3)
    fleet = gw.fleet("echo")
    sup = FleetSupervisor(gw, "echo", target=3, record=True)
    try:
        cli = gw.connect("c0")
        for k in range(12):
            cli.call("echo", np.arange(4, dtype=np.uint8))
        victim = fleet._replicas[1]
        fleet._mark_dead(victim)
        plan = sup.sweep()
        assert ("release", 1) in plan and ("join", 1) in plan
        assert sup.stats["releases"] == 1 and sup.stats["respawns"] == 1
        active = [r for r in fleet.snapshot() if r["state"] == "active"]
        assert len(active) == 3
        assert victim.state not in (REPLICA_ACTIVE, REPLICA_DEAD)
        # the next sweep sees a converged fleet: the corpse was released
        # exactly once (no re-key storm)
        assert sup.sweep() == []
        assert sup.stats["releases"] == 1
        # respawns come from the fleet's stored spawn spec (the LAST
        # add()'s handler — tag 2 here); the corpse's tag can never
        # reappear and every post-heal call still lands correctly
        seen = set()
        for _ in range(30):
            out = cli.call("echo", np.arange(4, dtype=np.uint8))
            assert H.host(out)[:4].tolist() == [0, 1, 2, 3]
            seen.add(_tag(out))
        assert 1 not in seen
        sup.replay()
        cli.close()
    finally:
        gw.close()


def test_supervisor_drains_surplus_to_target():
    gw = _inproc_fleet(4)
    fleet = gw.fleet("echo")
    sup = FleetSupervisor(gw, "echo", target=2)
    try:
        plan = sup.sweep()
        assert sum(1 for op, _ in plan if op == "drain") == 2
        # drains actuate asynchronously via the re-drain set; one more
        # sweep quiesces them (nothing is in flight)
        sup.sweep()
        active = [r for r in fleet.snapshot() if r["state"] == "active"]
        assert len(active) == 2
        assert sup.stats["drains"] == 2
    finally:
        gw.close()


def test_supervisor_ejects_latency_outlier():
    """A wedged-but-alive replica (EWMA far past the peer median) is
    drained and replaced: the probe can't catch it, the ejection policy
    does."""
    gw = _inproc_fleet(4)
    fleet = gw.fleet("echo")
    sup = FleetSupervisor(gw, "echo", target=4, eject_factor=4.0)
    try:
        for rep in fleet._replicas.values():
            rep.served = 100
            rep.ewma_ms = 5.0
        fleet._replicas[2].ewma_ms = 500.0
        sup.sweep()
        assert sup.stats["ejections"] == 1
        sup.sweep()                     # re-drain + converge
        snap = fleet.snapshot()
        active = [r for r in snap if r["state"] == "active"]
        assert len(active) == 4
        assert all(r["rid"] != 2 for r in active)
        assert sup.stats["respawns"] >= 1
    finally:
        gw.close()


def test_supervisor_lifecycle_guards():
    gw = _inproc_fleet(1)
    try:
        with pytest.raises(ValueError):
            FleetSupervisor(gw, "echo", target=0)
        sup = FleetSupervisor(gw, "echo", target=1,
                              interval=0.05).start()
        with pytest.raises(RuntimeError):
            sup.start()
        time.sleep(0.3)
        sup.stop()
        assert sup.stats["sweeps"] >= 1
    finally:
        gw.close()


def test_supervisor_replay_detects_divergence():
    """A tampered trace fails replay loudly — the planner really is the
    single source of the actuation decisions."""
    gw = _inproc_fleet(2)
    sup = FleetSupervisor(gw, "echo", target=2, record=True)
    try:
        sup.sweep()
        no, probes, snap, _plan = sup.trace[0]
        sup.trace[0] = (no, probes, snap, (("join", 5),))
        with pytest.raises(AssertionError):
            sup.replay()
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# proc: real replica processes, real kill -9 (CI fleet job)
# ---------------------------------------------------------------------------

def _proc_fleet(n=3):
    gw = ServiceGateway("mpklink_opt")
    for i in range(n):
        gw.register_replica("echo", _tagged(i), transport_kwargs=_PROC_KW)
    return gw.start()


def _warm(cli, fleet, n):
    """Drive enough traffic that every replica has started its child
    (procwire starts it lazily on the first request)."""
    for _ in range(12 * n):
        cli.call("echo", np.arange(4, dtype=np.uint8))
        if all(r.session._proc is not None
               for r in fleet._replicas.values()
               if r.state == REPLICA_ACTIVE):
            return
    raise AssertionError("fleet never warmed")


def _wait_healed(sup, fleet, target, min_respawns, timeout=30.0):
    """Wait until the supervisor has actually detected + replaced the
    corpse (a freshly killed child still snapshots as 'active' until a
    probe or routed request notices)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        active = [r for r in fleet.snapshot() if r["state"] == "active"]
        if (sup.stats["respawns"] >= min_respawns
                and len(active) == target):
            return active
        time.sleep(0.05)
    raise AssertionError(
        f"never healed to {target} with >= {min_respawns} respawns: "
        f"{sup.stats} {fleet.snapshot()}")


@pytest.mark.proc
def test_supervisor_converges_under_continuous_kill9():
    """Two rounds of kill -9 against live proc replicas: the probe loop
    detects each death, releases the corpse (one re-key each), respawns
    fresh proc-backed capacity, and traffic stays correct after every
    heal. The recorded trace replays exactly."""
    gw = _proc_fleet(3)
    fleet = gw.fleet("echo")
    sup = FleetSupervisor(gw, "echo", target=3, interval=0.05,
                          probe_timeout=2.0, record=True)
    try:
        cli = gw.connect("c0", retries=3)
        _warm(cli, fleet, 3)
        sup.start()
        for round_no in range(2):
            victims = [r for r in fleet._replicas.values()
                       if r.state == REPLICA_ACTIVE
                       and r.session._proc is not None]
            os.kill(victims[0].session._proc.pid, signal.SIGKILL)
            _wait_healed(sup, fleet, 3, round_no + 1)
            _warm(cli, fleet, 3)        # fresh replicas start lazily too
            for k in range(10):
                out = cli.call("echo", np.arange(4, dtype=np.uint8))
                assert H.host(out)[:4].tolist() == [0, 1, 2, 3]
        sup.stop()
        assert sup.stats["deaths_detected"] >= 2
        assert sup.stats["respawns"] >= 2
        assert sup.stats["releases"] >= 2
        sup.replay()
        cli.close()
    finally:
        sup.stop()
        gw.close()


@pytest.mark.proc
def test_supervisor_probe_detects_silent_death():
    """A kill -9 victim with NO traffic against it is still detected:
    the probe RPC itself proves the link dead (the router alone would
    only learn at the next routed request)."""
    gw = _proc_fleet(2)
    fleet = gw.fleet("echo")
    sup = FleetSupervisor(gw, "echo", target=2, interval=0.05,
                          probe_timeout=2.0)
    try:
        cli = gw.connect("c0", retries=3)
        _warm(cli, fleet, 2)
        victim = next(r for r in fleet._replicas.values()
                      if r.session._proc is not None)
        os.kill(victim.session._proc.pid, signal.SIGKILL)
        # no traffic at all — only the supervisor's probes run
        sup.start()
        _wait_healed(sup, fleet, 2, 1)
        sup.stop()
        assert sup.stats["deaths_detected"] >= 1
        assert sup.stats["respawns"] >= 1
        cli.close()
    finally:
        sup.stop()
        gw.close()


# ---------------------------------------------------------------------------
# the planners against the reference's, on the same snapshots
# ---------------------------------------------------------------------------

_STATES = ("active", "draining", "quiesced", "dead")
_NAMES = ("wc", "infer", "echo", "a", "b", "svc-1", "svc-2", "z")


@st.composite
def _fleet_snapshots(draw):
    n = draw(st.integers(0, 8))
    rids = draw(st.lists(st.integers(0, 40), min_size=n, max_size=n,
                         unique=True))
    snap = []
    for rid in rids:
        snap.append({"rid": rid,
                     "state": draw(st.sampled_from(_STATES)),
                     "inflight": draw(st.integers(0, 4)),
                     "ewma_ms": draw(st.one_of(
                         st.none(), st.floats(0.0, 1e3, allow_nan=False))),
                     "served": draw(st.integers(0, 200)),
                     "crashes": draw(st.integers(0, 3))})
    return snap


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(_fleet_snapshots(), st.integers(0, 8))
def test_plan_fleet_scaling_equals_the_reference(snap, target):
    assert plan_fleet_scaling(snap, target) \
        == ref_elastic.plan_fleet_scaling(snap, target)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(_fleet_snapshots(), st.floats(1.0, 8.0), st.integers(2, 5),
       st.integers(0, 100))
def test_plan_outlier_ejection_equals_the_reference(snap, factor, peers,
                                                    served):
    kw = dict(factor=factor, min_peers=peers, min_served=served)
    assert plan_outlier_ejection(snap, **kw) \
        == ref_elastic.plan_outlier_ejection(snap, **kw)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(st.dictionaries(st.sampled_from(_NAMES),
                       st.sampled_from(("closed", "open", "half_open")),
                       max_size=8),
       st.sets(st.sampled_from(_NAMES), max_size=4))
def test_plan_gateway_recovery_equals_the_reference(states, restartable):
    health = {k: {"state": v, "failures": 0} for k, v in states.items()}
    assert elastic.plan_gateway_recovery(health, restartable) \
        == ref_elastic.plan_gateway_recovery(health, restartable)


def test_planners_equal_the_reference_on_a_live_fleet_snapshot():
    """The snapshots the supervisor actually feeds them: a live fleet's
    after a death and an outlier."""
    gw = _inproc_fleet(4)
    try:
        fleet = gw.fleet("echo")
        cli = gw.connect("c0")
        for _ in range(20):
            cli.call("echo", np.arange(4, dtype=np.uint8))
        for rep in fleet._replicas.values():
            rep.served, rep.ewma_ms = 100, 5.0
        fleet._replicas[3].ewma_ms = 90.0
        fleet._mark_dead(fleet._replicas[1])
        snap = fleet.snapshot()
        for target in range(6):
            assert plan_fleet_scaling(snap, target) \
                == ref_elastic.plan_fleet_scaling(snap, target)
        assert plan_outlier_ejection(snap) \
            == ref_elastic.plan_outlier_ejection(snap) == [("eject", 3)]
        health = gw.health()
        assert elastic.plan_gateway_recovery(health, {"echo"}) \
            == ref_elastic.plan_gateway_recovery(health, {"echo"})
        cli.close()
    finally:
        gw.close()
