"""The reference's coalescer cases (``tests/test_coalescer.py``) run
against the port's ``CallCoalescer`` on the CPU, under their own names:
cohorts form and answers stay right, per-item isolation, the caller's
authorization before folding, the carrier's direct-path fallback, the
adaptive window, cohort admission through a ``batch_handler`` (and the
port's ``EngineService``), and duplicate tokens executing once. The cases
that inject faults through ``faultwire`` (``test_chaos_*``,
``test_dropped_cohort_response_never_double_executes``,
``test_crashed_cohort_recovers_per_item``) wait for it (ROADMAP.md, queue
1, item 3)."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import ServiceGateway as _ServiceGateway
from repro_torch.core.domains import AccessViolation
from repro_torch.core.transports import TransportError
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
    kw.setdefault("device", "cpu")
    return _ServiceGateway(*args, **kw)


WALL_BUDGET = 90.0


def _mux_gateway(transport="mpklink_opt", *, timeout=30.0, factory=True,
                 max_batch=32, max_wait_us=400.0, **svc_kw):
    gw = ServiceGateway(transport, max_keys=512,
                        transport_kwargs={"timeout": timeout})
    gw.register_service(
        "wordcount", wordcount_handler,
        factory=(lambda: wordcount_handler) if factory else None, **svc_kw)
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
        assert not t.is_alive()
    return clients, results, errors


def test_cohorts_form_and_answers_stay_correct():
    gw, mux = _mux_gateway()
    try:
        n_clients, reps = 12, 6
        clients, results, errors = _hammer(gw, n_clients, reps)
        total = n_clients * reps
        assert not errors, errors[:3]
        for (i, j), out in results.items():
            assert parse_count(out) == 3 + (i + j) % 7
        assert mux.stats["coalesced_calls"] == total
        assert mux.stats["cohorts"] < total, "nothing coalesced"
        assert mux.stats["max_cohort"] > 1
        # every request MAC-verified on both sides despite the folding
        assert gw.stats["macs_verified"] >= total
        assert mux._carrier.macs_verified == total
        assert gw.stats["rejected"] == 0
    finally:
        gw.close()


def test_single_caller_stays_ordered_and_correct():
    gw, mux = _mux_gateway()
    try:
        c = gw.connect("solo")
        c.open("wordcount")
        for j in range(10):
            assert parse_count(c.call("wordcount",
                                      make_text(j + 1, seed=j))) == j + 1
        assert mux.stats["coalesced_calls"] == 10
    finally:
        gw.close()


def test_poisoned_item_does_not_fail_cohort_mates():
    """One caller sends payloads its handler rejects; cohort-mates in the
    same envelope must complete normally — per-item typed errors."""
    def picky(req):
        raw = np.asarray(req).reshape(-1).view(np.uint8)
        if raw[:6].tobytes() == b"poison":
            raise ValueError("poisoned payload refused")
        return wordcount_handler(req)

    gw = ServiceGateway("mpklink_opt", max_keys=512,
                        transport_kwargs={"timeout": 30.0})
    gw.register_service("picky", picky)
    gw.start()
    mux = gw.enable_coalescing(max_batch=32, max_wait_us=2000.0)
    try:
        def payload(i, j):
            if i == 0:
                return np.frombuffer(b"poison", np.uint8)
            return make_text(3 + (i + j) % 5, seed=i * 7 + j)

        clients, results, errors = _hammer(gw, 8, 4, payload, service="picky")
        # caller 0's calls failed typed; everyone else's succeeded
        poisoned = [e for (i, e) in errors if i == 0]
        assert poisoned and all(isinstance(e, TransportError)
                                for e in poisoned), errors
        assert all(i == 0 for i, _ in errors), errors
        for (i, j), out in results.items():
            assert i != 0
            assert parse_count(out) == 3 + (i + j) % 5
        assert mux.stats["max_cohort"] > 1
    finally:
        gw.close()


def test_stale_epoch_rekeys_transparently_under_coalescing():
    """A revocation bumps the service-domain epoch mid-run; the mux re-keys
    through the CA and the coalesced calls keep succeeding — same
    transparent recovery as the direct path."""
    gw, mux = _mux_gateway()
    try:
        c = gw.connect("rekey")
        c.open("wordcount")
        assert parse_count(c.call("wordcount", make_text(4, seed=0))) == 4
        victim = gw.connect("victim")
        victim.open("wordcount")
        gw.revoke(victim, "wordcount")          # epoch bump: carrier stale
        assert parse_count(c.call("wordcount", make_text(6, seed=1))) == 6
        assert mux.stats["rekeys"] >= 1
    finally:
        gw.close()


def test_caller_acl_enforced_before_folding():
    """A client outside the allow-list must be rejected even though the
    (allowed) carrier would have accepted the envelope — folding cannot
    launder authorization."""
    gw = ServiceGateway("mpklink_opt", max_keys=512)
    gw.register_service("vip", wordcount_handler,
                        allow={"alice", "gw:coalescer"})
    gw.start()
    gw.enable_coalescing()
    try:
        alice = gw.connect("alice")
        assert parse_count(alice.call("vip", make_text(5, seed=0))) == 5
        mallory = gw.connect("mallory")
        with pytest.raises(AccessViolation):
            mallory.call("vip", make_text(5, seed=0))
    finally:
        gw.close()


def test_service_refusing_carrier_keeps_direct_path():
    """An allow-list that excludes the carrier identity silently disables
    coalescing for that service — calls still work, directly."""
    gw = ServiceGateway("mpklink_opt", max_keys=512)
    gw.register_service("private", wordcount_handler, allow={"bob"})
    gw.start()
    mux = gw.enable_coalescing()
    try:
        bob = gw.connect("bob")
        assert parse_count(bob.call("private", make_text(4, seed=0))) == 4
        assert not mux.accepts("private")
        assert mux.stats["coalesced_calls"] == 0
    finally:
        gw.close()


def test_closed_mux_falls_back_to_direct_calls():
    gw, mux = _mux_gateway()
    try:
        c = gw.connect("after-close")
        c.open("wordcount")
        assert parse_count(c.call("wordcount", make_text(3, seed=0))) == 3
        mux.close()
        assert parse_count(c.call("wordcount", make_text(5, seed=1))) == 5
    finally:
        gw.close()


def test_adaptive_window_tracks_arrival_rate():
    gw, mux = _mux_gateway(max_batch=64, max_wait_us=300.0)
    try:
        cap = 300.0 / 1e6
        mux._ewma_gap = None                    # no history: full window
        assert mux._window_s() == cap
        mux._ewma_gap = 1e-6                    # dense burst: scale to fill
        assert mux._window_s() == pytest.approx(63e-6)
        mux._ewma_gap = 1.0                     # sparse: don't wait at all
        assert mux._window_s() == 0.0
    finally:
        gw.close()


def test_batch_handler_admits_cohort_as_one_unit():
    """A coalesced cohort for a batch_handler service executes as ONE
    native batch call (the scatter channel-group cohort path)."""
    sizes = []

    def batch_wc(payloads):
        sizes.append(len(payloads))
        return [wordcount_handler(p) for p in payloads]

    gw = ServiceGateway("mpklink_opt", max_keys=512)
    gw.register_service("wc", wordcount_handler, batch_handler=batch_wc)
    gw.start()
    gw.enable_coalescing(max_batch=32, max_wait_us=3000.0)
    try:
        clients, results, errors = _hammer(gw, 8, 3, service="wc")
        assert not errors, errors[:3]
        for (i, j), out in results.items():
            assert parse_count(out) == 3 + (i + j) % 7
        assert sum(sizes) == 24, "some items bypassed the batch handler"
        assert max(sizes) > 1, "no cohort reached the batch handler whole"
    finally:
        gw.close()


def test_engine_service_cohort_joins_decode_grid_as_one_unit():
    """The real serving path: auto-coalesced inline inference calls reach
    the port's EngineService.handler_batch as one cohort submission."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import init_params
    from repro_torch.runtime import EngineService, ServingEngine, encode_prompt

    cfg = get_reduced("llama3.2-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    engine = ServingEngine(cfg, params, max_batch=8, max_seq=32, device="cpu")
    svc = EngineService(engine, timeout=120.0).start()
    gw = ServiceGateway("mpklink_opt", max_keys=512,
                        transport_kwargs={"timeout": 120.0})
    gw.register_service("infer", svc.handler, batch_handler=svc.handler_batch)
    gw.start()
    gw.enable_coalescing(max_batch=8, max_wait_us=50000.0)
    try:
        warm = gw.connect("warm")
        warm.open("infer")
        warm.call("infer", encode_prompt([1, 2], max_new=2))

        n = 5
        clients = [gw.connect(f"inf-{i}") for i in range(n)]
        for c in clients:
            c.open("infer")
        outs: dict = {}
        errs: list = []
        barrier = threading.Barrier(n)

        def worker(i):
            try:
                barrier.wait()
                outs[i] = clients[i].call(
                    "infer", encode_prompt([1 + i, 2, 3], max_new=3))
            except Exception as e:
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WALL_BUDGET)
            assert not t.is_alive()
        assert not errs, errs[:2]
        assert all(np.asarray(outs[i]).size == 3 for i in range(n))
        assert any(c > 1 for c in svc.cohorts), \
            f"no multi-request cohort reached the engine: {svc.cohorts}"
    finally:
        gw.close()
        svc.close()


def test_duplicate_tokens_in_one_envelope_execute_once_loop_path():
    """call_many with a repeated idempotency token: the second item must be
    answered from the dedup window, not re-executed (the sequential-item
    semantics, preserved across the two-pass scatter refactor)."""
    calls = []

    def counting(req):
        calls.append(np.asarray(req).copy())
        return wordcount_handler(req)

    gw = ServiceGateway("mpklink_opt", max_keys=512)
    gw.register_service("wc", counting)
    gw.start()
    try:
        c = gw.connect("dup")
        c.open("wc")
        [tok] = c.mint_tokens(1)
        p = make_text(5, seed=1)
        r1, r2 = c.call_many([("wc", p), ("wc", p)], tokens=[tok, tok])
        assert parse_count(r1) == parse_count(r2) == 5
        assert len(calls) == 1, "duplicate token re-executed the handler"
        assert gw.stats["deduped"] == 1
    finally:
        gw.close()


def test_duplicate_tokens_in_one_envelope_execute_once_batch_path():
    """Same contract when the service routes through a native
    batch_handler: the duplicate stays out of the cohort submission."""
    seen = []

    def batch_wc(payloads):
        seen.append(len(payloads))
        return [wordcount_handler(p) for p in payloads]

    gw = ServiceGateway("mpklink_opt", max_keys=512)
    gw.register_service("wc", wordcount_handler, batch_handler=batch_wc)
    gw.start()
    try:
        c = gw.connect("dup-b")
        c.open("wc")
        [tok] = c.mint_tokens(1)
        other = c.mint_tokens(1)[0]
        p, q = make_text(4, seed=1), make_text(6, seed=2)
        r1, r2, r3 = c.call_many([("wc", p), ("wc", q), ("wc", p)],
                                 tokens=[tok, other, tok])
        assert parse_count(r1) == parse_count(r3) == 4
        assert parse_count(r2) == 6
        assert seen == [2], f"cohort submitted {seen}, want the 2 unique"
    finally:
        gw.close()
