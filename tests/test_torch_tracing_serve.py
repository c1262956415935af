"""The program's spans on the CPU: the reduced engine behind the port's
``ServiceGateway("mpklink_opt")`` with the recorder armed (admission
stamps, ``engine.queued`` with its call id, the tick's ``host_reads``,
each call's device reads inside its ``gateway.call``), the train step's
phases, and ``EngineService.handler`` against a racing ``close()``."""
import threading
import time

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import OptimizerConfig, TrainConfig, get_reduced
from repro_torch.core import ServiceGateway
from repro_torch.models import init_params
from repro_torch.optim import init_opt_state
from repro_torch.runtime import EngineService, ServingEngine, encode_prompt
from repro_torch.runtime import serve as serve_mod
from repro_torch.runtime.steps import make_train_step

PROMPTS = [[5, 9, 2], [7, 7, 1, 3, 20], [11], [4, 8, 15, 16], [3, 3], [9]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_recorder():
    tracing.disarm()
    tracing.drain()
    yield
    tracing.disarm()
    tracing.drain()


def _engine(max_batch=2, max_seq=32):
    cfg = get_reduced("llama3.2-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                         dtype=torch.float32, device="cpu")


class _Watch:
    """Keeps every submitted request, and before each tick's bookkeeping
    counts the slots that generate a token in it."""

    def __init__(self, eng):
        self.reqs, self.generating = [], []
        sub, smp = eng.submit, eng.sample

        def submit(req):
            self.reqs.append(req)
            sub(req)

        def sample(last):
            self.generating.append(sum(
                1 for b, r in enumerate(eng.slots)
                if r is not None and eng.prompt_cursor[b] >= len(r.prompt)))
            return smp(last)

        eng.submit, eng.sample = submit, sample


def test_engine_behind_the_gateway_records_its_spans():
    eng = _engine()
    watch = _Watch(eng)
    svc = EngineService(eng, timeout=120.0).start()
    gw = ServiceGateway("mpklink_opt", max_keys=64, device="cpu",
                        transport_kwargs={"timeout": 120.0})
    gw.register_service("infer", svc.handler)
    gw.start()
    clients = [gw.connect(f"c{i}") for i in range(3)]
    errors = []

    def caller(k):
        try:
            for p in PROMPTS[k::3]:
                out = clients[k].call("infer", encode_prompt(p, 3))
                assert out.shape == (3,)
        except Exception as e:          # reported below
            errors.append(e)

    tracing.arm()
    try:
        ts = [threading.Thread(target=caller, args=(k,)) for k in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
    finally:
        tracing.disarm()
        gw.close()
        svc.close()
    assert not errors and not any(t.is_alive() for t in ts)
    spans = tracing.drain()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)

    # admission: a stamp on every request, one queued span with its call id
    calls = {s.call for s in by["gateway.call"]}
    assert len(watch.reqs) == len(PROMPTS) == len(calls) and None not in calls
    queued = {s.attrs["rid"]: s for s in by["engine.queued"]}
    assert len(by["engine.queued"]) == len(queued) == len(PROMPTS)
    for r in watch.reqs:
        assert r.admitted_at >= r.submitted_at >= r.entered_at > 0
        q = queued[r.rid]
        assert r.call in calls and q.call == r.call
        assert q.end_ns - q.start_ns >= 0

    # the tick: host_reads is the sampled tokens' read + one a generating slot
    ticks = sorted((s for s in by["engine.tick"] if s.attrs["live"]),
                   key=lambda s: s.start_ns)
    assert len(ticks) == len(watch.generating) > 0
    assert [s.attrs["host_reads"] for s in ticks] == \
        [1 + g for g in watch.generating]
    assert max(s.attrs["live"] for s in ticks) == 2
    assert sum(s.attrs["admitted"] for s in by["engine.tick"]) == len(PROMPTS)
    kids = {s.span: s for s in ticks}
    for name in ("engine.admit", "engine.decode_step", "engine.sample",
                 "engine.bookkeep"):
        inside = [s for s in by[name] if s.parent in kids]
        assert len(inside) == len(ticks), name

    # the gateway: every device read of a call lies inside its gateway.call
    span_of = {s.call: s for s in by["gateway.call"]}
    reads = [s for s in by["gateway.device_read"] if s.call is not None]
    assert {s.call for s in reads} == calls
    for s in reads:
        c = span_of[s.call]
        assert c.start_ns <= s.start_ns <= s.end_ns <= c.end_ns
    for name in ("gateway.dispatch", "gateway.handler", "service.handler",
                 "service.submit"):
        assert {s.call for s in by[name]} == calls, name


def test_train_step_records_one_accumulate_span_a_later_microbatch():
    cfg = get_reduced("llama3.2-1b")
    params = init_params(cfg, torch.Generator().manual_seed(1))
    tcfg = TrainConfig(microbatch_size=1, dtype="float32",
                       optimizer=OptimizerConfig(warmup_steps=1, total_steps=4))
    step = make_train_step(cfg, tcfg)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (4, 8), generator=g)
    batch = {"tokens": toks, "labels": toks}
    opt = init_opt_state(params)
    tracing.arm()
    params, opt, _ = step(params, opt, batch)
    tracing.disarm()
    spans = tracing.drain()
    names = [s.name for s in spans]
    assert names.count("train_step.forward") == names.count("train_step.backward") == 4
    assert names.count("train_step.optimizer") == 1
    acc = [s for s in spans if s.name == "train_step.accumulate"]
    assert sorted(s.attrs["micro"] for s in acc) == [1, 2, 3]
    fwd = sorted(s.attrs["micro"] for s in spans if s.name == "train_step.forward")
    assert fwd == [0, 1, 2, 3]
    step(params, opt, batch)                # off: nothing recorded
    assert tracing.drain() == []


def test_a_handler_racing_close_returns_at_once(monkeypatch):
    """A call whose handler is between its parse and its registration when
    ``close()`` runs is refused at once, not left to its timeout."""
    svc = EngineService(_engine(), timeout=600.0).start()
    closed = threading.Event()
    real = serve_mod.gateway.current_priority

    def late_priority():
        closed.wait(10)
        return real()

    monkeypatch.setattr(serve_mod.gateway, "current_priority", late_priority)
    out = {}

    def call():
        t = time.monotonic()
        try:
            svc.handler(encode_prompt([1, 2], 2))
            out["err"] = None
        except RuntimeError as e:
            out["err"] = e
        out["s"] = time.monotonic() - t

    th = threading.Thread(target=call)
    th.start()
    time.sleep(0.05)
    svc.close()
    closed.set()
    th.join(30)
    assert not th.is_alive() and out["s"] < 20
    assert "closed" in str(out["err"])
