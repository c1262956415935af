"""The span recorder (``repro_torch.tracing``): off records nothing, spans
nest per thread with parent ids, concurrent threads lose no span, ``drain``
empties the buffers, call ids pass to children, and the spans share the
``torch.profiler`` trace's clock."""
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing


@pytest.fixture(autouse=True)
def _clean_recorder():
    tracing.disarm()
    tracing.drain()
    yield
    tracing.disarm()
    tracing.drain()


def test_off_records_nothing_and_hands_back_the_shared_null_span():
    arms = tracing.RECORDER.arms
    with tracing.span("a") as sp:
        assert sp is tracing.NULL and not sp
        sp.set(n=1)
        with tracing.span("b"):
            tracing.set_call(1, 2)
            assert tracing.current_call() is None
    tracing.emit("c", 0, 1, rid=3)
    with tracing.phase("train_step.forward", micro=0):
        pass
    assert tracing.drain() == []
    assert tracing.RECORDER.arms == arms and not tracing.RECORDER.armed


def test_spans_nest_per_thread_with_parent_ids_and_attributes():
    tracing.arm()
    with tracing.span("outer", call=7) as outer:
        with tracing.span("inner") as inner:
            inner.set(n=3)
            inner.set(m=4)
        tracing.emit("stamped", time.perf_counter_ns() - 1000,
                     time.perf_counter_ns(), rid=9)

    def other():
        with tracing.span("elsewhere"):
            pass

    t = threading.Thread(target=other)
    t.start()
    t.join(10)
    tracing.disarm()
    spans = {s.name: s for s in tracing.drain()}
    assert set(spans) == {"outer", "inner", "stamped", "elsewhere"}
    o, i, e = spans["outer"], spans["inner"], spans["elsewhere"]
    assert o.parent == 0 and i.parent == o.span and spans["stamped"].parent == o.span
    assert i.call == 7 and o.call == 7 and e.call is None
    assert i.attrs == {"n": 3, "m": 4} and spans["stamped"].attrs == {"rid": 9}
    assert e.parent == 0 and e.thread != o.thread
    assert o.thread == threading.get_native_id() and o.ident == threading.get_ident()
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns


def test_a_call_id_set_later_reaches_children_drained_with_it():
    tracing.arm()
    with tracing.span("gateway.dispatch"):
        with tracing.span("gateway.device_read"):
            pass
        tracing.set_call(3, 5)
        with tracing.span("gateway.handler"):
            assert tracing.current_call() == tracing.call_id(3, 5)
    tracing.disarm()
    spans = tracing.drain()
    assert {s.call for s in spans} == {(3 << 32) | 5}


def test_eight_threads_lose_no_span():
    n, per = 8, 500
    tracing.arm()
    start = threading.Barrier(n)

    def work(k):
        start.wait()
        for j in range(per):
            with tracing.span("w", call=k):
                pass

    ts = [threading.Thread(target=work, args=(k,)) for k in range(n)]
    for t in ts:
        t.start()
    got = []
    while any(t.is_alive() for t in ts):       # drains race the writers
        got += tracing.drain()
    for t in ts:
        t.join(30)
    tracing.disarm()
    got += tracing.drain()
    assert len(got) == n * per
    assert len({s.span for s in got}) == n * per
    for k in range(n):
        assert sum(s.call == k for s in got) == per


def test_drain_empties_the_buffers_and_open_spans_finish_after_disarm():
    tracing.arm()
    with tracing.span("x"):
        tracing.disarm()
        with tracing.span("not recorded"):
            pass
    assert [s.name for s in tracing.drain()] == ["x"]
    assert tracing.drain() == []


def test_phase_opens_its_range_whether_armed_or_not():
    def names(armed):
        if armed:
            tracing.arm()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.phase("train_step.optimizer"):
                torch.ones(4).sum()
            with tracing.span("engine.tick"):
                pass
        tracing.disarm()
        return [e.name for e in prof.events()], tracing.drain()

    off, off_spans = names(False)
    on, on_spans = names(True)
    assert "train_step.optimizer" in off and "engine.tick" not in off
    assert off_spans == []
    assert "train_step.optimizer" in on and "engine.tick" in on
    assert [s.name for s in on_spans] == ["train_step.optimizer", "engine.tick"]


def _clock_gap_ns() -> float:
    """One span around a ``record_function`` block: the larger distance
    between the drained span's ends and the profiler's event's."""
    tracing.arm()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("warm"):
                pass
        with tracing.span("mine"):
            with record_function("block"):
                torch.ones(64).sum()
                time.sleep(0.002)
    tracing.disarm()
    start = prof.profiler.kineto_results.trace_start_ns()
    ev, = [e for e in prof.events() if e.name == "block"]
    sp, = [s for s in tracing.drain() if s.name == "mine"]
    assert sp.end_ns - sp.start_ns >= 2e6
    return max(abs(sp.start_ns - (start + ev.time_range.start * 1e3)),
               abs(sp.end_ns - (start + ev.time_range.end * 1e3)))


def test_spans_land_on_the_profilers_clock():
    """A span around a ``record_function`` block, once drained, lies within
    0.5 ms of the profiler's event for that block (the best of a few
    tries: a busy machine can preempt the thread between the two)."""
    with profile(activities=[ProfilerActivity.CPU]):    # the profiler's start-up
        with record_function("warm"):
            torch.ones(4).sum()
    assert min(_clock_gap_ns() for _ in range(3)) < 5e5


def test_frame_stats_shares_the_shard_registry():
    from repro_torch.core import framing
    assert isinstance(framing.STATS, tracing.ThreadShards)
    assert isinstance(tracing.RECORDER, tracing.ThreadShards)
