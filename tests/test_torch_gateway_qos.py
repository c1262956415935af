"""The reference's QoS cases (``tests/test_qos.py``) run against the port's
gateway on the CPU, under their own names: token buckets and typed
``RateLimited`` sheds, the lane-12 priority class end to end, the
coalescer's priority window, weighted fair queues, the shard executor's
tenant interleave, the fleet's fair gate, retry budgets, and priority
admission in the port's ``ServingEngine``."""
import random
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import ServiceGateway as _ServiceGateway, framing
from repro_torch.core.gateway import (WFQ_QUANTUM, RetryBudget, TokenBucket,
                                      WeightedFairQueue, _FairGate, _Shard,
                                      current_priority, priority_rank)
from repro_torch.core.transports import (DeadlineExpired, Overloaded,
                                         RateLimited, ServiceUnavailable)
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



def _echo(req):
    return np.ascontiguousarray(np.asarray(req))


def _payload(i=0):
    return np.arange(i, i + 4, dtype=np.int32)


# ---------------------------------------------------------------------------
# token bucket + RateLimited over the wire
# ---------------------------------------------------------------------------

def test_token_bucket_unit():
    b = TokenBucket(rate=10.0, burst=2.0)
    assert b.try_take() == 0.0
    assert b.try_take() == 0.0
    wait = b.try_take()
    assert wait > 0.0
    # retry_after is the exact deficit: < 1 token missing at 10/s
    assert wait <= 0.1 + 1e-6
    assert b.admitted == 2 and b.shed == 1
    time.sleep(wait + 0.02)
    assert b.try_take() == 0.0          # refilled at the promised time
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=1.0)
    with pytest.raises(ValueError):
        TokenBucket(rate=1.0, burst=0.5)


def test_rate_limit_sheds_typed_and_isolates_tenants():
    """The abuser's bucket sheds typed RateLimited (retry_after crosses
    the wire, isinstance-compatible with Overloaded backoff handlers);
    the victim identity is untouched."""
    gw = ServiceGateway("mpklink_opt")
    gw.register_service("echo", _echo)
    gw.start()
    try:
        gw.set_rate_limit("abuser", rate=5.0, burst=2)
        abuser = gw.connect("abuser")
        victim = gw.connect("victim")
        abuser.call("echo", _payload())
        abuser.call("echo", _payload())
        with pytest.raises(RateLimited) as ei:
            abuser.call("echo", _payload())
        assert ei.value.retry_after > 0.0
        assert isinstance(ei.value, Overloaded)          # §7 taxonomy
        assert isinstance(ei.value, ServiceUnavailable)
        # the victim never competes with the abuser's bucket
        for i in range(8):
            np.testing.assert_array_equal(
                np.asarray(victim.call("echo", _payload(i))), _payload(i))
        assert gw.stats["rate_limited"] >= 1
        qs = gw.qos_stats()["abuser"]
        assert qs["rate"] == 5.0 and qs["shed"] >= 1 and qs["admitted"] == 2
        # a cooperative client that waits retry_after is admitted again
        time.sleep(ei.value.retry_after + 0.05)
        abuser.call("echo", _payload())
        abuser.close()
        victim.close()
    finally:
        gw.close()


def test_rate_limit_batch_envelope_is_atomic():
    """A batch envelope is admitted or shed whole (n tokens) — a shed
    executes zero items and is fully replayable after refill."""
    gw = ServiceGateway("mpklink_opt")
    gw.register_service("wordcount", wordcount_handler)
    gw.start()
    try:
        gw.set_rate_limit("bulk", rate=50.0, burst=4)
        c = gw.connect("bulk")
        before = gw.stats["responses"]
        with pytest.raises(RateLimited) as ei:
            c.call_batch("wordcount", [make_text(10, seed=j)
                                       for j in range(6)])
        assert gw.stats["responses"] == before      # nothing executed
        time.sleep(ei.value.retry_after + 0.05)
        outs = c.call_batch("wordcount", [make_text(10, seed=j)
                                          for j in range(4)])
        assert [parse_count(o) for o in outs] == [10] * 4
        c.close()
    finally:
        gw.close()


def test_rate_limit_charges_caller_not_coalescer_carrier():
    """Coalesced calls are charged against the CALLER identity before
    folding into the carrier mux — multiplexing is not a laundering
    path (§10.2)."""
    gw = ServiceGateway("mpklink_opt", max_keys=128)
    gw.register_service("wordcount", wordcount_handler)
    gw.start()
    gw.enable_coalescing(max_batch=8, max_wait_us=200.0)
    try:
        gw.set_rate_limit("greedy", rate=2.0, burst=1)
        c = gw.connect("greedy")
        assert parse_count(c.call("wordcount", make_text(7))) == 7
        with pytest.raises(RateLimited):
            c.call("wordcount", make_text(7))
        assert gw.qos_stats()["greedy"]["shed"] >= 1
        c.close()
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# lane-12 priority word
# ---------------------------------------------------------------------------

def test_priority_lane_roundtrip_and_mac_covered():
    arr = np.arange(16, dtype=np.int32)
    for prio in (framing.PRIO_NORMAL, framing.PRIO_HIGH, framing.PRIO_BULK):
        f = _build_frame(arr, seed=7, seq=0, priority=prio)
        assert framing.frame_priority(_t(f)) == prio
        out = _parse_frame(f, seed=7, expect_seq=0)
        np.testing.assert_array_equal(np.asarray(out), arr)
    # flipping the priority word breaks the MAC like any header bit
    f = _build_frame(arr, seed=7, seq=1, priority=framing.PRIO_HIGH)
    bad = f.copy()
    bad[0, framing.PRIORITY_LANE] = framing.PRIO_BULK
    with pytest.raises(framing.FrameError):
        _parse_frame(bad, seed=7, expect_seq=1)
    # out-of-range class is rejected even with a recomputed-looking word
    with pytest.raises(framing.FrameError):
        _parse_frame(
            _with_lane(f, framing.PRIORITY_LANE, 3), seed=7, expect_seq=1)


def _with_lane(frame, lane, value):
    out = frame.copy()
    out[0, lane] = value
    return out


def test_priority_rank_total_order():
    order = sorted([framing.PRIO_BULK, framing.PRIO_HIGH,
                    framing.PRIO_NORMAL], key=priority_rank)
    assert order == [framing.PRIO_HIGH, framing.PRIO_NORMAL,
                     framing.PRIO_BULK]
    assert priority_rank(99) == priority_rank(framing.PRIO_NORMAL)


def test_priority_reaches_handler_thread_local():
    """The lane-12 word is decoded at dispatch and published to the
    handler via current_priority() — per call, reverting after."""
    seen = []

    def handler(req):
        seen.append(current_priority())
        return _echo(req)

    gw = ServiceGateway("mpklink_opt")
    gw.register_service("echo", handler)
    gw.start()
    try:
        c = gw.connect("cli")
        c.call("echo", _payload())
        c.call("echo", _payload(), priority=framing.PRIO_HIGH)
        c.call("echo", _payload(), priority=framing.PRIO_BULK)
        outs = c.call_many(
            [("echo", _payload(i)) for i in range(2)],
            priorities=[framing.PRIO_HIGH, framing.PRIO_HIGH])
        assert len(outs) == 2
        assert seen[:3] == [framing.PRIO_NORMAL, framing.PRIO_HIGH,
                            framing.PRIO_BULK]
        assert all(p == framing.PRIO_HIGH for p in seen[3:])
        assert current_priority() == framing.PRIO_NORMAL    # reverted
        c.close()
    finally:
        gw.close()


def test_coalescer_high_priority_skips_wait_window():
    """A HIGH entry collapses the coalescer window to zero: with a large
    max_wait_us and no other traffic the call must return far sooner
    than the bulk window would allow (§10.1)."""
    gw = ServiceGateway("mpklink_opt", max_keys=128)
    gw.register_service("wordcount", wordcount_handler)
    gw.start()
    mux = gw.enable_coalescing(max_batch=32, max_wait_us=300_000.0)
    try:
        c = gw.connect("cli")
        c.call("wordcount", make_text(5))       # warm the channel + mux
        t0 = time.monotonic()
        n = parse_count(c.call("wordcount", make_text(9),
                               priority=framing.PRIO_HIGH))
        elapsed = time.monotonic() - t0
        assert n == 9
        assert elapsed < 0.15, f"HIGH call waited {elapsed:.3f}s"
        assert mux.stats["cohorts"] >= 1
        c.close()
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# weighted fair queuing: DRR queue, shard executor, fleet slot gate
# ---------------------------------------------------------------------------

def test_wfq_interleaves_by_quantum():
    q = WeightedFairQueue(weight_of=lambda k: 1.0)
    for i in range(8):
        q.push(("a", i), key="a", cost=1)
    for i in range(8):
        q.push(("b", i), key="b", cost=1)
    order = []
    while True:
        got = q.pop(timeout=0.0)
        if got is None:
            break
        order.append(got[0][0])
    # quantum=4 → four units per flow per round, FIFO within a flow
    assert "".join(order) == "aaaabbbbaaaabbbb"


def test_wfq_share_tracks_weight():
    q = WeightedFairQueue(weight_of=lambda k: 2.0 if k == "heavy" else 1.0)
    for i in range(24):
        q.push(("heavy", i), key="heavy", cost=1)
        q.push(("light", i), key="light", cost=1)
    first = [q.pop(timeout=0.0)[0][0] for _ in range(12)]
    share = first.count("heavy") / 12
    assert share >= 7 / 12, first       # 2:1 weights → ~2/3 of early service


def test_wfq_single_flow_is_fifo():
    q = WeightedFairQueue(weight_of=lambda k: 1.0)
    for i in range(10):
        q.push(i, key="only", cost=3)   # cost > quantum still drains FIFO
    out = []
    while True:
        got = q.pop(timeout=0.0)
        if got is None:
            break
        out.append(got[0])
    assert out == list(range(10))


def test_wfq_close_drains_then_signals():
    q = WeightedFairQueue(weight_of=lambda k: 1.0)
    q.push("x", key="a", cost=1)
    q.close()
    assert q.pop(timeout=1.0)[0] == "x"     # close drains queued work
    assert q.pop(timeout=0.05) is None      # then reports closed


def test_shard_executor_interleaves_tenants():
    """The sharded executor serves backlogged tenants round-robin: a
    flood queued first no longer runs ahead of the victim's entire
    backlog (§10.3)."""
    gate = threading.Event()
    order = []

    def work(tag):
        def fn():
            gate.wait(5.0)
            order.append(tag)
        return fn

    sh = _Shard(0, weight_of=lambda k: 1.0)
    try:
        # park the shard on an untagged item first, so that the whole
        # backlog below is queued before the shard pops any of it (left to
        # thread timing, the shard can pop the flood's first item alone
        # and start its quantum before the victim has queued)
        started = threading.Event()
        parked = sh.submit(lambda: (started.set(), gate.wait(5.0)))
        assert started.wait(5.0)
        boxes = [parked]
        # the flood lands first...
        for i in range(2 * WFQ_QUANTUM):
            boxes.append(sh.submit(work("flood"), key="flood", cost=1))
        # ...then the victim queues behind it
        for i in range(WFQ_QUANTUM):
            boxes.append(sh.submit(work("victim"), key="victim", cost=1))
        gate.set()
        for box, done in boxes:
            assert done.wait(10.0)
        # the victim's first item ran within the first flood quantum + 1
        first_victim = order.index("victim")
        assert first_victim <= WFQ_QUANTUM, order
    finally:
        sh.close()


def test_fair_gate_blocks_at_capacity_and_shares():
    g = _FairGate(2, weight_of=lambda k: 1.0)
    assert g.acquire("a", 1, None)
    assert g.acquire("a", 1, None)
    assert g.inflight() == 2
    t0 = time.monotonic()
    assert not g.acquire("b", 1, time.monotonic() + 0.05)
    assert time.monotonic() - t0 >= 0.04    # parked until the deadline
    assert g.inflight() == 2                 # expired waiter charged nothing
    g.release(1)
    assert g.acquire("b", 1, time.monotonic() + 1.0)
    g.release(1)
    g.release(1)
    assert g.inflight() == 0


def test_fair_gate_oversized_cohort_admits_alone():
    g = _FairGate(4, weight_of=lambda k: 1.0)
    assert g.acquire("big", 32, None)        # clamped to capacity
    assert not g.acquire("small", 1, time.monotonic() + 0.05)
    g.release(32)                            # symmetric clamp — drains fully
    assert g.inflight() == 0
    assert g.acquire("small", 1, None)
    g.release(1)


def test_fleet_fair_queue_end_to_end():
    """Fair queuing over fleet slots: both tenants complete under a
    capacity-1 gate, double-enable is an error, and a waiter whose
    deadline expires at the gate sheds typed DeadlineExpired."""
    def slow(req):
        time.sleep(0.02)
        return _echo(req)

    gw = ServiceGateway("mpklink_opt")
    for _ in range(2):
        gw.register_replica("echo", slow, transport="mpklink_opt")
    gw.start()
    fleet = gw.fleet("echo")
    fleet.enable_fair_queue(1)
    with pytest.raises(RuntimeError):
        fleet.enable_fair_queue(1)
    try:
        errs = []

        def run(name, reps):
            try:
                c = gw.connect(name)
                for i in range(reps):
                    out = c.call("echo", _payload(i))
                    assert np.asarray(out).tobytes() == _payload(i).tobytes()
                c.close()
            except Exception as e:      # pragma: no cover - surfaced below
                errs.append((name, repr(e)))

        ts = [threading.Thread(target=run, args=(f"tenant-{i}", 6))
              for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errs, errs
        assert fleet.stats["fair_queued"] >= 12
        # a queued waiter with a spent budget sheds typed at the gate
        blocker = gw.connect("blocker")
        hurried = gw.connect("hurried")
        # occupy the only slot with a slow call, then race a tiny budget
        hold = threading.Thread(
            target=lambda: blocker.call("echo", _payload()))
        hold.start()
        time.sleep(0.005)
        with pytest.raises(DeadlineExpired):
            hurried.call("echo", _payload(), timeout=0.01)
        hold.join(30)
        blocker.close()
        hurried.close()
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# cross-feature invariants (ISSUE satellites 2 + 3)
# ---------------------------------------------------------------------------

def test_retry_budget_refills_after_running_dry():
    """Regression (§9.3): primaries completing AFTER the bucket ran dry
    still earn ratio tokens — a dry budget must not disable retries
    forever."""
    b = RetryBudget(ratio=0.5, burst=1, initial=0.0)
    assert not b.take()                 # dry: extra attempt refused
    b.note_primary()
    b.note_primary()
    assert b.tokens() == pytest.approx(1.0)
    assert b.take()                     # refilled by later primaries
    assert b.spent == 1 and b.denied == 1


def test_fleet_primaries_earn_budget_when_dry():
    """The fleet dispatch path calls note_primary() on completion even
    when the budget started empty — hedging recovers."""
    gw = ServiceGateway("mpklink_opt")
    for _ in range(2):
        gw.register_replica("echo", _echo, transport="mpklink_opt")
    gw.start()
    try:
        budget = RetryBudget(ratio=0.25, burst=2, initial=0.0)
        gw.fleet("echo").enable_hedging(delay=30.0, budget=budget)
        c = gw.connect("cli")
        for i in range(4):
            c.call("echo", _payload(i))
        assert budget.tokens() == pytest.approx(1.0)
        c.close()
    finally:
        gw.close()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rate_limited_sheds_never_charge_brownout(seed):
    """Property (§10.2, no double penalty): across randomized admit/shed
    interleavings, a RateLimited shed must not move the brownout gauge —
    brownout admissions equal successful responses, the gauge drains to
    zero, and brownout itself never engages from rate-limit pressure."""
    rng = random.Random(seed)
    gw = ServiceGateway("mpklink_opt")
    gw.register_service("echo", _echo)
    gw.start()
    bo = gw.enable_brownout("echo", high_water=64)
    try:
        gw.set_rate_limit("noisy", rate=20.0, burst=2)
        noisy = gw.connect("noisy")
        quiet = gw.connect("quiet")
        ok = limited = 0
        for i in range(40):
            c, tag = (noisy, "noisy") if rng.random() < 0.6 \
                else (quiet, "quiet")
            try:
                if rng.random() < 0.25:
                    c.call_batch("echo", [_payload(i), _payload(i + 1)])
                    ok += 2
                else:
                    c.call("echo", _payload(i))
                    ok += 1
            except RateLimited:
                assert tag == "noisy"   # only the bucketed tenant sheds
                limited += 1
        assert limited > 0              # the interleaving exercised sheds
        snap = bo.snapshot()
        assert snap["inflight"] == 0    # gauge fully drained
        assert snap["sheds"] == 0       # rate-limit never became brownout
        assert snap["engagements"] == 0
        assert gw.stats["responses"] == ok
        noisy.close()
        quiet.close()
    finally:
        gw.close()


def test_serving_engine_admits_by_priority():
    """ServingEngine._admit boards the most urgent class first, FIFO
    within a class (pure FIFO when everything is PRIO_NORMAL)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import init_params
    from repro_torch.runtime import Request, ServingEngine

    cfg = get_reduced("llama3.2-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, max_batch=1, max_seq=32, device="cpu")
    eng.submit(Request(rid=0, prompt=[1, 2], max_new=2,
                       priority=framing.PRIO_NORMAL))
    eng.submit(Request(rid=1, prompt=[3, 4], max_new=2,
                       priority=framing.PRIO_BULK))
    eng.submit(Request(rid=2, prompt=[5, 6], max_new=2,
                       priority=framing.PRIO_HIGH))
    done = eng.run_until_drained()
    assert [r.rid for r in done] == [2, 0, 1]
