"""The spans' reduction (``harness/spans.py``) and the third plan
(``span_trace.py``) on the CPU: attribution by correlation id and by the
driving thread on a made-up trace, then the tiny cells with the recorder
armed, and the benchmark's own runs, which never arm it."""
import pytest
import torch

from perfbench import span_trace
from perfbench.harness import spans as spans_mod
from perfbench.harness.cell import run_cell
from perfbench.tests.tiny import one_thread, tiny_cell
from repro_torch import tracing
from repro_torch.tracing import SpanRecord

MS = 1_000_000


def _s(name, a, b, thread, span, parent=0, call=None, **attrs):
    return SpanRecord(name, a * MS, b * MS, thread, thread + 1000, span, parent,
                      call, attrs or None)


ENGINE, CLIENT, SESSION = 1, 2, 3
SPANS = [
    _s("engine.tick", 0, 40, ENGINE, 1, live=2, admitted=1, host_reads=3),
    _s("engine.admit", 0, 2, ENGINE, 2, 1),
    _s("engine.queued", 0, 1, ENGINE, 3, 2, call=77, rid=0),
    _s("engine.decode_step", 2, 20, ENGINE, 4, 1),
    _s("engine.sample", 20, 35, ENGINE, 5, 1),
    _s("engine.bookkeep", 35, 40, ENGINE, 6, 1),
    _s("engine.tick", 40, 80, ENGINE, 7, live=2, admitted=0, host_reads=1),
    _s("engine.decode_step", 40, 60, ENGINE, 8, 7),
    _s("gateway.call", 5, 70, CLIENT, 9, call=77),
    _s("gateway.device_read", 10, 14, CLIENT, 10, 9, call=77),
    _s("gateway.device_read", 30, 31, SESSION, 11),      # before the dispatch
    _s("gateway.dispatch", 32, 60, SESSION, 12, call=77),
    _s("gateway.device_read", 33, 34, SESSION, 13, 12, call=77),
    _s("gateway.device_read", 90, 91, SESSION, 14),      # after the call
]
# kernels: (start, end, name, correlation ids)
DEVICE = [(5 * MS, 15 * MS, "gemm", (1, 0)), (25 * MS, 30 * MS, "gemm", (2, 0)),
          (32 * MS, 33 * MS, "guard_copy", (3, 0)), (50 * MS, 70 * MS, "gemm", (4, 0)),
          (71 * MS, 72 * MS, "x", (9, 0))]
# runtime calls by correlation id: (start, the thread as the trace names it:
# a pthread id, a native id, or one with no spans, here 999)
RUNTIME = {1: (3 * MS, 999), 2: (21 * MS, ENGINE + 1000),
           3: (30.5 * MS, SESSION + 1000), 4: (45 * MS, ENGINE)}


def test_reduce_attributes_kernels_gaps_and_the_spans_numbers():
    red = spans_mod.reduce(DEVICE, RUNTIME, SPANS, 0, 80 * MS, "engine.tick")
    k = red["kernel_s"]
    assert k["engine.decode_step"] == pytest.approx(0.030)      # 10 + 20 ms
    assert k["engine.sample"] == pytest.approx(0.005)
    assert k["gateway.device_read"] == pytest.approx(0.001)
    assert k[spans_mod.OUTSIDE] == pytest.approx(0.001)         # no runtime call
    assert red["unmatched_launches"] == 1 and red["foreign_launches"] == 1
    assert red["busy_s"] == pytest.approx(0.037)
    idle = red["idle_s"]            # gaps 0–5, 15–25, 30–32, 33–50, 70–71, 72–80
    assert idle["engine.admit"] == pytest.approx(0.005)
    assert idle["engine.decode_step"] == pytest.approx(0.010)
    assert idle["engine.sample"] == pytest.approx(0.002 + 0.017)
    assert idle["engine.tick"] == pytest.approx(0.001 + 0.008)
    assert sum(idle.values()) == pytest.approx(0.080 - 0.037)
    m = red["metrics"]
    # idle outside decode_step: 0–2, 20–25, 30–32, 33–40, 70–71, 72–80: 25 ms
    assert m["host_idle_share"] == pytest.approx(100 * 25 / 80)
    assert m["queue_wait_ms"] == pytest.approx(1.0)
    assert m["host_reads_per_tick"] == pytest.approx(2.0)
    # call 77: its own reads 4 + 1 ms, the session's read inside its span 1 ms
    assert m["guard_wait_ms"] == pytest.approx(6.0)
    assert red["calls"] == pytest.approx({"n": 1, "call_ms": 65.0, "dispatch_ms": 28.0,
                                          "handler_ms": 0.0, "service_ms": 0.0,
                                          "submit_ms": 0.0, "device_read_ms": 6.0})
    assert m["optimizer_share"] is None and m["grad_accum_share"] is None
    assert red["n"]["engine.tick"] == 2 and red["host_s"]["gateway.call"] == pytest.approx(0.065)


def test_reduce_reads_the_train_phases_shares_of_busy_time():
    sp = [_s("train_step.forward", 0, 10, 1, 1), _s("train_step.backward", 10, 20, 1, 2),
          _s("train_step.accumulate", 20, 22, 1, 3, micro=1),
          _s("train_step.optimizer", 22, 30, 1, 4)]
    dev = [(1 * MS, 21 * MS, "gemm", (1, 0)), (21 * MS, 23 * MS, "add", (2, 0)),
           (23 * MS, 31 * MS, "adam", (3, 0))]
    rt = {1: (1 * MS, 1001), 2: (20.5 * MS, 1001), 3: (23 * MS, 1001)}
    red = spans_mod.reduce(dev, rt, sp, 0, 30 * MS, "train_step.forward")
    busy = 0.029
    assert red["busy_s"] == pytest.approx(busy)
    assert red["metrics"]["grad_accum_share"] == pytest.approx(100 * 0.002 / busy)
    assert red["metrics"]["optimizer_share"] == pytest.approx(100 * 0.007 / busy)


def test_on_cost_compares_each_armed_block_with_its_neighbours():
    oc = spans_mod.on_cost([1.0, 1.1, 1.0, 1.3, 1.2])
    assert oc["armed_over_disarmed"] == pytest.approx([0.1, 1.3 / 1.1 - 1])
    assert oc["median"] == pytest.approx(1.3 / 1.1 - 1)


def test_the_third_plan_on_the_tiny_serve_cell():
    """``rec["trace"]`` keeps the two plans' keys; the third gives the
    spans, whose host-side numbers read on the CPU."""
    arms = tracing.RECORDER.arms
    cell = tiny_cell("grok-1-314b.serve")
    cell.traffic["profile_ticks"] = 48      # some admissions and calls begin in it
    with one_thread():
        text, out, extra = span_trace.run(cell, 2**31 + 29, 1.0, torch.device("cpu"),
                                          0.0, 3)
    tr = out.rec["trace"]
    assert set(tr) == {"busy_s", "families", "host_op_device_s", "idle_by_host",
                       "kernels", "kv", "live", "ops", "steps", "ticks", "wall_s"}
    assert set(tr["ops"]) == set(tr) - {"ops"}
    red = extra["spans"]
    for name in ("engine.tick", "engine.decode_step", "engine.queued",
                 "gateway.device_read", "service.submit"):
        assert red["n"].get(name), name
    m = red["metrics"]
    for name in ("queue_wait_ms", "host_reads_per_tick", "guard_wait_ms"):
        assert m[name] is not None and m[name] >= 0, name
    assert m["host_reads_per_tick"] >= 1
    assert m["host_idle_share"] is None         # no device here
    assert len(extra["on_cost"]["blocks_s"]) == 3
    assert extra["on_cost"]["span"]["armed_us"] > 0 and extra["on_cost"]["span"]["off_us"] > 0
    assert tracing.RECORDER.arms == arms + 3 and not tracing.RECORDER.armed
    assert tracing.drain() == []


def test_the_third_plan_on_the_tiny_train_cell():
    cell = tiny_cell("qwen3-14b.train")
    with one_thread():
        _, out, extra = span_trace.run(cell, 2**31 + 31, 0.5, torch.device("cpu"),
                                       0.0, 3)
    n = extra["spans"]["n"]
    assert n["train_step.optimizer"] == cell.traffic["profile_steps"]
    # two microbatches a step: one sum after the first
    assert n["train_step.accumulate"] == n["train_step.optimizer"]
    assert n["train_step.forward"] == 2 * n["train_step.optimizer"]
    assert "launches" in out.rec["trace"] and not tracing.RECORDER.armed


@pytest.mark.parametrize("workload,trace", [("grok-1-314b.serve", 0),
                                            ("qwen3-14b.train", 1)])
def test_the_benchmarks_own_runs_never_arm_the_recorder(workload, trace):
    arms = tracing.RECORDER.arms
    with one_thread():
        run_cell(tiny_cell(workload), 2**31 + 37, 0.5, bool(trace),
                 torch.device("cpu"), 0.0)
    assert tracing.RECORDER.arms == arms and tracing.drain() == []
