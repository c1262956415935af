"""The port's serving engine and service step against the JAX engine on
reduced llama3.2-1b: identical greedy tokens for the same (converted)
parameters, ``EngineService.handler`` / ``handler_batch`` behind the
service step with frames sealed by either package, typed crashes and
recovery, and the lane-10/12 request context."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import framing as jf
from repro.models import init_params as jinit_params
from repro.models.transformer import Impl as JImpl
from repro.runtime import Request as JRequest
from repro.runtime import ServingEngine as JServingEngine

from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import framing as pf
from repro_torch.core import gateway
from repro_torch.core import transports as pt
from repro_torch.runtime import (EngineService, Request, ServingEngine,
                                 encode_prompt)

SEED = 0x5EED
JIMPL = JImpl(attention="naive", remat=False)
JCFG = jget_reduced("llama3.2-1b")


@pytest.fixture(scope="module")
def params():
    jparams = jinit_params(JCFG, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _engine(tparams, **kw):
    return ServingEngine(get_reduced("llama3.2-1b"), tparams,
                         dtype=torch.float32, device="cpu", **kw)


def _jax_tokens(jparams, prompts, max_new, max_batch, max_seq, one_by_one=False):
    eng = JServingEngine(JCFG, jparams, max_batch=max_batch, max_seq=max_seq,
                         impl=JIMPL)
    out = {}
    for i, p in enumerate(prompts):
        eng.submit(JRequest(rid=i, prompt=p, max_new=max_new))
        if one_by_one:
            out.update({r.rid: r.generated for r in eng.run_until_drained()})
    out.update({r.rid: r.generated for r in eng.run_until_drained()})
    return out, eng


def test_engine_tokens_match_jax_engine(params):
    jparams, tparams = params
    prompts = [[1 + i, 2, 3] for i in range(6)]
    want, jeng = _jax_tokens(jparams, prompts, 5, 4, 64)
    eng = _engine(tparams, max_batch=4, max_seq=64)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=5))
    done = eng.run_until_drained()
    assert {r.rid: r.generated for r in done} == want
    assert all(len(g) == 5 for g in want.values())
    assert eng.ticks == jeng.ticks < 6 * (3 + 5)            # batching happened


def test_idle_slot_overflow_matches_jax_engine(params):
    """Three requests one after another on max_seq=8: the idle slot's
    position runs past the cache (the JAX engine ends at [7, 21])."""
    jparams, tparams = params
    prompts = [[4, 5, 6], [7, 8], [9, 10, 11, 12]]
    want, jeng = _jax_tokens(jparams, prompts, 4, 2, 8, one_by_one=True)
    eng = _engine(tparams, max_batch=2, max_seq=8)
    got = {}
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=4))
        got.update({r.rid: r.generated for r in eng.run_until_drained()})
    assert got == want
    assert eng.state["pos"].tolist() == np.asarray(jeng.state["pos"]).tolist()
    assert max(eng.state["pos"].tolist()) > 8


def _service(tparams, **kw):
    return EngineService(_engine(tparams, max_batch=4, max_seq=64), **kw).start()


def test_handler_behind_service_step_both_sealers(params):
    jparams, tparams = params
    prompts = [[1 + i, 2, 3] for i in range(4)]
    want, _ = _jax_tokens(jparams, prompts, 5, 4, 64)
    svc = _service(tparams, timeout=60)
    results, errors = {}, []

    def client(i):
        try:
            req = encode_prompt(prompts[i], max_new=5)
            frame = (pf.build_frame(req, seed=SEED, seq=i, device="cpu") if i % 2
                     else torch.from_numpy(jf.build_frame(req, seed=SEED, seq=i)))
            resp = pt.serve_frame(frame, svc.handler, seed=SEED, seq=i)
            ref_view = jf.parse_frame(resp.numpy(), seed=SEED, expect_seq=i)
            ours = pf.parse_frame(resp, seed=SEED, expect_seq=i)
            assert np.array_equal(ref_view, ours.numpy())
            results[i] = ours.tolist()
        except BaseException as e:          # surfaced by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        svc.close()
    assert not errors, errors
    assert results == want


def test_handler_batch_envelope_keeps_item_errors(params):
    jparams, tparams = params
    prompts = [[1 + i, 2, 3] for i in range(4)]
    want, _ = _jax_tokens(jparams, prompts, 5, 4, 64)
    reqs = [encode_prompt(p, max_new=5) for p in prompts]
    frames = pf.seal_batch(reqs, seed=SEED, start_seq=100, device="cpu")
    frames[2][1, 0] ^= 1                                     # tamper item 2
    svc = _service(tparams, timeout=60)
    try:
        out = pt.serve_batch(torch.cat(frames), svc.handler_batch, seed=SEED,
                             seqs=list(range(100, 104)))
    finally:
        svc.close()
    assert isinstance(out[2], pf.FrameError)
    assert svc.cohorts == [3]
    got = pf.verify_batch([out[i] for i in (0, 1, 3)], seed=SEED,
                          seqs=[100, 101, 103])
    assert [g.tolist() for g in got] == [want[0], want[1], want[3]]
    ref = jf.verify_batch([out[i].numpy() for i in (0, 1, 3)], seed=SEED,
                          seqs=[100, 101, 103])
    assert [r.tolist() for r in ref] == [want[0], want[1], want[3]]


def test_refused_frame_never_reaches_the_handler(params):
    calls = []
    frame = pf.build_frame(encode_prompt([1, 2]), seed=SEED, seq=0, device="cpu")
    frame[1, 0] ^= 1
    with pytest.raises(pf.FrameError):
        pt.serve_frame(frame, calls.append, seed=SEED, seq=0)
    assert calls == []


def test_inject_crash_is_typed_then_engine_recovers(params):
    _, tparams = params
    svc = _service(tparams, timeout=60)
    try:
        real_tick, fired = svc.engine.tick, []

        def tick():                         # crash while a request decodes
            progressed = real_tick()
            if not fired and any(s is not None for s in svc.engine.slots):
                fired.append(True)
                svc.inject_crash()
            return progressed

        svc.engine.tick = tick
        frame = pf.build_frame(encode_prompt([1, 2, 3], 40), seed=SEED, seq=0,
                               device="cpu")
        box = {}
        t = threading.Thread(target=lambda: box.update(r=_try(
            lambda: pt.serve_frame(frame, svc.handler, seed=SEED, seq=0))))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert isinstance(box["r"], pt.ServiceCrashed), box["r"]
        assert svc.crashes == 1
        frame = pf.build_frame(encode_prompt([1, 2, 3], 3), seed=SEED, seq=1,
                               device="cpu")
        resp = pt.serve_frame(frame, svc.handler, seed=SEED, seq=1)
        assert len(pf.parse_frame(resp, seed=SEED, expect_seq=1)) == 3
    finally:
        svc.close()


def _try(fn):
    try:
        return fn()
    except BaseException as e:
        return e


def test_service_step_publishes_deadline_and_priority():
    seen = {}

    def handler(req):
        seen["prio"] = gateway.current_priority()
        seen["budget"] = gateway.remaining_budget()
        return np.asarray(req.tolist(), np.int32)

    frame = pf.build_frame(np.arange(3, dtype=np.int32), seed=SEED, seq=4,
                           deadline_us=5_000_000, priority=pf.PRIO_HIGH,
                           device="cpu")
    resp = pt.serve_frame(frame, handler, seed=SEED, seq=4)
    assert pf.parse_frame(resp, seed=SEED, expect_seq=4).tolist() == [0, 1, 2]
    assert seen["prio"] == pf.PRIO_HIGH and 0 < seen["budget"] <= 5.0
    assert gateway.current_priority() == pf.PRIO_NORMAL     # restored
    assert gateway.remaining_budget() is None
    expired = pf.build_frame(np.arange(3, dtype=np.int32), seed=SEED, seq=5,
                             deadline_us=1, device="cpu")
    with pytest.raises(pt.DeadlineExpired):
        pt.serve_frame(expired, handler, seed=SEED, seq=5)


def test_priority_admission_order(params):
    _, tparams = params
    eng = _engine(tparams, max_batch=1, max_seq=32)
    eng.submit(Request(rid=0, prompt=[1], max_new=1, priority=pf.PRIO_BULK))
    eng.submit(Request(rid=1, prompt=[2], max_new=1, priority=pf.PRIO_HIGH))
    eng.submit(Request(rid=2, prompt=[3], max_new=1))
    assert [r.rid for r in eng.run_until_drained()] == [1, 2, 0]


def test_entry_points_need_cuda_unless_asked_for_cpu(params):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(get_reduced("llama3.2-1b"), params[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        pf.build_frame(np.zeros(2, np.int32), seed=0, seq=0)
