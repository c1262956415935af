"""The reference's propagated-deadline, retry-budget and brownout cases
(``tests/test_deadline.py``) run against the port's gateway on the CPU,
under their own names."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import ServiceGateway as _ServiceGateway, framing
from repro_torch.core.gateway import RetryBudget, _Brownout
from repro_torch.core.transports import (DeadlineExpired, Overloaded,
                                         ResponseTimeout, ServiceUnavailable)
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler


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


def _build_frame(*args, **kw):
    """A frame sealed by the port on the CPU, as a numpy array (the cases
    edit and concatenate it as the reference's do)."""
    kw.setdefault("device", "cpu")
    return framing.build_frame(*args, **kw).numpy()


def _t(frame):
    return torch.from_numpy(np.ascontiguousarray(frame))


def _parse_frame(frame, **kw):
    return framing.parse_frame(_t(frame), **kw)



# ---------------------------------------------------------------------------
# the deadline word itself: lane 10, MAC-covered, saturating encode
# ---------------------------------------------------------------------------

def test_deadline_to_us_encoding():
    """None → 0 (no deadline), already-expired → 1 (minimum non-zero so
    'expired' survives the wire), huge → saturates at the lane max."""
    assert framing.deadline_to_us(None) == 0
    assert framing.deadline_to_us(0.0) == 1
    assert framing.deadline_to_us(-5.0) == 1
    assert framing.deadline_to_us(1.0) == 1_000_000
    assert framing.deadline_to_us(1e9) == framing.DEADLINE_US_MAX


def test_deadline_word_rides_the_frame():
    arr = make_text(9, seed=0)
    f = _build_frame(arr, seed=0xAB, seq=3, deadline_us=123_456)
    assert framing.frame_deadline_us(_t(f)) == 123_456
    out = _parse_frame(f, seed=0xAB, expect_seq=3)
    np.testing.assert_array_equal(out, arr)


def test_deadline_word_is_mac_covered():
    """An attacker cannot extend (or shrink) a propagated deadline in
    flight: flipping lane 10 after sealing breaks MAC verification."""
    f = _build_frame(make_text(5, seed=1), seed=0xAB, seq=1,
                            deadline_us=50_000)
    f[0][framing.DEADLINE_LANE] = framing.DEADLINE_US_MAX
    with pytest.raises(framing.FrameError):
        _parse_frame(f, seed=0xAB, expect_seq=1)


def test_frame_without_deadline_reads_zero():
    f = _build_frame(make_text(5, seed=2), seed=0xAB, seq=1)
    assert framing.frame_deadline_us(_t(f)) == 0


# ---------------------------------------------------------------------------
# server-side shed: expired work never reaches the handler
# ---------------------------------------------------------------------------

def _gw(**kw):
    gw = ServiceGateway("mpklink_opt", **kw)
    gw.register_service("wordcount", wordcount_handler)
    return gw.start()


def test_expired_work_shed_before_execution():
    """_run_guarded sheds a request whose propagated deadline has already
    passed: typed DeadlineExpired, the handler never runs, and the
    gateway's ``expired`` counter records the shed."""
    ran = []
    gw = ServiceGateway("mpklink_opt")
    gw.register_service("probe", lambda req: (ran.append(1),
                                              np.asarray(req))[1])
    gw.start()
    try:
        svc = gw._services["probe"]
        with pytest.raises(DeadlineExpired):
            gw._run_guarded(svc, np.zeros(3, np.uint8),
                            deadline=time.monotonic() - 0.5)
        assert ran == []
        assert gw.stats["expired"] == 1
        # an unexpired deadline admits normally
        out = gw._run_guarded(svc, np.arange(3, dtype=np.uint8),
                              deadline=time.monotonic() + 30.0)
        assert np.asarray(out).tolist() == [0, 1, 2]
        assert ran == [1]
    finally:
        gw.close()


def test_client_zero_budget_fails_typed_without_send():
    """timeout=0 expires at the loop top — typed DeadlineExpired, no wire
    traffic, no handler execution."""
    gw = _gw()
    try:
        c = gw.connect("c0")
        before = gw.stats["requests"]
        with pytest.raises(DeadlineExpired):
            c.call("wordcount", make_text(4, seed=0), timeout=0)
        assert gw.stats["requests"] == before
        c.close()
    finally:
        gw.close()


def test_deadline_expired_is_a_response_timeout():
    """DeadlineExpired subclasses ResponseTimeout: callers netting the
    liveness family catch it, callers wanting the typed distinction get
    it. It must NOT read as overload."""
    assert issubclass(DeadlineExpired, ResponseTimeout)
    assert not issubclass(DeadlineExpired, ServiceUnavailable)
    assert issubclass(Overloaded, ServiceUnavailable)


# ---------------------------------------------------------------------------
# the mux regression (ISSUE 9 satellite): deadline rides through the
# coalescer — a 1s budget fails typed in ~1s, not the old +30s slack
# ---------------------------------------------------------------------------

def test_mux_deadline_fails_in_about_one_second():
    """A 1s-deadline call through the coalescer against a wedged service
    must fail TYPED in roughly the budget, not the carrier's old
    ``transport.timeout * 2 + 30.0`` liveness slack."""
    release = threading.Event()

    def wedged(req):
        release.wait(20.0)
        return np.asarray(req)

    gw = ServiceGateway("mpklink_opt")
    gw.register_service("wedged", wedged)
    gw.start()
    gw.enable_coalescing(max_wait_us=500.0)
    try:
        c = gw.connect("c0")
        t0 = time.monotonic()
        with pytest.raises(ResponseTimeout):
            c.call("wedged", np.arange(4, dtype=np.uint8), timeout=1.0)
        elapsed = time.monotonic() - t0
        # budget + one coalescing window + scheduling slack — nowhere
        # near the old 30s constant
        assert elapsed < 5.0, f"took {elapsed:.1f}s; old +30.0 bound back?"
        c.close()
    finally:
        release.set()
        gw.close()


def test_mux_calls_without_deadline_still_complete():
    """No-deadline traffic through the mux is unaffected by the derived
    liveness bound."""
    gw = _gw()
    gw.enable_coalescing(max_wait_us=500.0)
    try:
        c = gw.connect("c0")
        for n in (5, 9, 13):
            assert parse_count(c.call("wordcount",
                                      make_text(n, seed=n))) == n
        c.close()
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# retry budget: token bucket over EXTRA attempts
# ---------------------------------------------------------------------------

def test_retry_budget_burst_then_dry():
    b = RetryBudget(ratio=0.1, burst=3)
    assert [b.take() for _ in range(3)] == [True] * 3
    assert b.take() is False
    assert b.spent == 3 and b.denied == 1


def test_retry_budget_earns_from_primaries():
    b = RetryBudget(ratio=0.25, burst=3, initial=0.0)
    assert b.take() is False
    for _ in range(4):
        b.note_primary()
    assert b.take() is True             # 4 primaries × 0.25 = 1 token
    assert b.take() is False


def test_retry_budget_caps_at_burst():
    b = RetryBudget(ratio=1.0, burst=2)
    for _ in range(50):
        b.note_primary()
    assert b.tokens() == 2.0


def test_retry_budget_rejects_bad_config():
    with pytest.raises(ValueError):
        RetryBudget(ratio=-0.1)
    with pytest.raises(ValueError):
        RetryBudget(burst=0)


def test_client_retries_draw_from_budget():
    """A client with a dry budget cannot retry even when ``retries`` says
    it may: the bucket is the binding cap on extra attempts."""
    gw = _gw()
    calls = {"n": 0}
    real = gw._services["wordcount"].handler

    def flaky(req):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ResponseTimeout("injected")
        return real(req)

    gw._services["wordcount"].handler = flaky
    try:
        budget = RetryBudget(ratio=0.0, burst=1, initial=0.0)
        c = gw.connect("c0", retries=3, retry_budget=budget)
        with pytest.raises(ResponseTimeout):
            c.call("wordcount", make_text(6, seed=0))
        assert budget.denied >= 1 and budget.spent == 0
        c.close()
        # with tokens, the same failure heals on the retry
        calls["n"] = 0
        budget2 = RetryBudget(ratio=0.1, burst=3)
        c2 = gw.connect("c1", retries=3, retry_budget=budget2)
        assert parse_count(c2.call("wordcount", make_text(6, seed=0))) == 6
        assert budget2.spent == 1
        c2.close()
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# brownout: hysteretic typed shedding
# ---------------------------------------------------------------------------

def test_brownout_hysteresis():
    """Trips at high water, sheds until drained to LOW water — no
    flapping at the boundary."""
    bo = _Brownout(high_water=4, low_water=2)
    for _ in range(4):
        bo.admit("svc")
    with pytest.raises(Overloaded):
        bo.admit("svc")                 # at high water: engaged
    bo.done(1, 5.0)                     # inflight 3 — still above low
    with pytest.raises(Overloaded):
        bo.admit("svc")
    bo.done(1, 5.0)                     # inflight 2 == low water: recover
    bo.admit("svc")
    snap = bo.snapshot()
    assert snap["engagements"] == 1 and snap["sheds"] == 2
    assert not snap["engaged"]


def test_brownout_retry_after_estimate():
    bo = _Brownout(high_water=2, low_water=1)
    bo.admit("svc")
    bo.done(1, 100.0)                   # seed the EWMA at 100ms
    bo.admit("svc")
    bo.admit("svc")
    with pytest.raises(Overloaded) as ei:
        bo.admit("svc")
    assert ei.value.retry_after > 0.0


def test_brownout_ewma_gate():
    """high_water_ms engages on service time alone, and recovery requires
    the EWMA to fall back below the gate."""
    bo = _Brownout(high_water=1000, low_water=1, high_water_ms=50.0)
    bo.admit("svc")
    bo.done(1, 200.0)                   # EWMA jumps past the gate
    with pytest.raises(Overloaded):
        bo.admit("svc")
    # completions drag the EWMA back under 50ms → recovery
    for _ in range(30):
        bo.inflight += 1
        bo.done(1, 1.0)
    bo.admit("svc")


def test_brownout_rejects_bad_water_marks():
    with pytest.raises(ValueError):
        _Brownout(high_water=4, low_water=8)
    with pytest.raises(ValueError):
        _Brownout(high_water=4, low_water=0)


def test_overloaded_sheds_typed_over_the_wire():
    """End to end: a saturated service sheds the next admission with a
    typed Overloaded carrying retry_after, reconstructed on the client
    side of the wire; hysteretic recovery admits again after the drain."""
    gate = threading.Event()
    entered = threading.Event()

    def blocking(req):
        entered.set()
        gate.wait(10.0)
        return np.asarray(req)

    gw = ServiceGateway("mpklink_opt")
    gw.register_service("busy", blocking)
    gw.start()
    gw.enable_brownout("busy", high_water=1, low_water=1)
    try:
        c = gw.connect("c0")
        holder = threading.Thread(
            target=lambda: c.call("busy", np.zeros(2, np.uint8)))
        holder.start()
        # probe only once the holder's call is admitted and inside the
        # handler: a probe that arrives first is admitted itself, the
        # holder is shed, and probes left blocked in the handler keep the
        # gauge above the low-water mark past the drain
        entered.wait(5.0)
        probe = gw.connect("probe")
        deadline = time.monotonic() + 5.0
        caught = None
        while time.monotonic() < deadline:
            try:
                probe.call("busy", np.zeros(2, np.uint8), timeout=0.5)
            except Overloaded as e:
                caught = e
                break
            except ResponseTimeout:
                continue
        gate.set()
        holder.join(timeout=10)
        assert caught is not None, "brownout never engaged"
        assert hasattr(caught, "retry_after")
        assert gw.stats["overloaded"] >= 1
        # hysteretic recovery: with the holder drained, admissions resume
        out = c.call("busy", np.arange(3, dtype=np.uint8), timeout=5.0)
        assert np.asarray(out).tolist() == [0, 1, 2]
        c.close()
    finally:
        gate.set()
        gw.close()


def test_enable_brownout_is_single_shot():
    gw = _gw()
    try:
        gw.enable_brownout("wordcount", high_water=8)
        with pytest.raises(RuntimeError):
            gw.enable_brownout("wordcount", high_water=8)
    finally:
        gw.close()


def test_overloaded_not_retried_without_budget():
    """Overloaded with retries=0 surfaces immediately — a shedding
    service must not be hammered by the default client."""
    gw = _gw()
    gw.enable_brownout("wordcount", high_water=1, low_water=1)
    bo = gw._services["wordcount"].brownout
    bo.engaged = True
    bo.inflight = 5
    try:
        c = gw.connect("c0")
        t0 = time.monotonic()
        with pytest.raises(Overloaded):
            c.call("wordcount", make_text(4, seed=0))
        assert time.monotonic() - t0 < 1.0
        c.close()
    finally:
        gw.close()
