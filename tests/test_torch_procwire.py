"""The reference's process-transport cases (``tests/test_procwire.py``) run
against the port's ``procwire`` on the CPU, under their own names: real
service processes over POSIX shared memory (shm_proc / mpklink_proc /
mpklink_opt_proc) and the loopback baselines (rest / sockrpc) — round
trips, typed errors across the boundary, real ``kill -9``, segment
hygiene. The port starts every child from a forkserver, so the
reference's closures are the module-level handlers of
``torch_proc_handlers`` (or ``functools.partial`` of them); every
assertion is the reference's."""
import functools
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_proc_handlers as H
from repro_torch.core import (ALL_TRANSPORTS as _ALL, BASELINE_TRANSPORTS,
                              PROC_TRANSPORTS, ServiceGateway as _Gateway,
                              procwire)
from repro_torch.core.transports import (CapacityError,
                                         ResponseTimeout, ServiceCrashed,
                                         TransportError, _recv_exact)
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler

pytestmark = pytest.mark.proc

NEW_TRANSPORTS = sorted(PROC_TRANSPORTS) + sorted(BASELINE_TRANSPORTS)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _OnCPU(dict):
    """``ALL_TRANSPORTS`` whose classes are built on the CPU (the port's
    default device is the card)."""

    def __getitem__(self, name):
        return functools.partial(_ALL[name], device="cpu")


ALL_TRANSPORTS = _OnCPU()


def ServiceGateway(*args, **kw):
    kw.setdefault("device", "cpu")
    return _Gateway(*args, **kw)


@pytest.fixture(autouse=True, scope="module")
def _port_proc_hygiene(request):
    yield
    H.proc_hygiene(request.module.__name__)


@pytest.fixture(autouse=True)
def _bounded():
    with H.bounded(120):
        yield


_echo = H.echo


def _bytes(out) -> bytes:
    return H.host(out).tobytes()


def _leftover_segments():
    return [f for f in os.listdir("/dev/shm")
            if f.startswith(procwire.SEGMENT_PREFIX)]


# ---------------------------------------------------------------------------
# roundtrips: every new transport behind the exact same Session API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW_TRANSPORTS)
def test_roundtrip_sizes(name):
    tr = ALL_TRANSPORTS[name](_echo, timeout=15.0)
    try:
        s = tr.connect()
        for nbytes in (1, 777, 65536):
            p = np.frombuffer(os.urandom(nbytes), np.uint8)
            out = s.request(p)
            assert _bytes(out) == bytes(p[::-1]), (name, nbytes)
        s.close()
    finally:
        tr.close()


@pytest.mark.parametrize("name", NEW_TRANSPORTS)
def test_call_batch_larger_than_ring(name):
    """Pipelined batches wider than the slot ring run in windows; the
    lockstep baselines buffer — either way order and content hold."""
    tr = ALL_TRANSPORTS[name](_echo, timeout=15.0)
    try:
        s = tr.connect()
        payloads = [np.frombuffer(os.urandom(100 + 13 * i), np.uint8)
                    for i in range(20)]            # 20 > DEFAULT_RING_SLOTS
        outs = s.call_batch(payloads)
        assert len(outs) == 20
        for p, o in zip(payloads, outs):
            assert _bytes(o) == bytes(p[::-1])
        s.close()
    finally:
        tr.close()


@pytest.mark.parametrize("name", sorted(PROC_TRANSPORTS))
def test_concurrent_sessions_are_isolated(name):
    """N sessions = N service processes with private segments/domains."""
    tr = ALL_TRANSPORTS[name](_echo, timeout=15.0)
    try:
        sessions = [tr.connect(f"c{i}") for i in range(3)]
        for rep in range(3):
            for i, s in enumerate(sessions):
                p = np.frombuffer(os.urandom(512 + 64 * i + rep), np.uint8)
                assert _bytes(s.request(p)) == bytes(p[::-1])
        pids = {s._proc.pid for s in sessions if s._proc is not None}
        assert len(pids) == 3                       # three real processes
        for s in sessions:
            s.close()
    finally:
        tr.close()


def test_mpklink_proc_sync_schedule():
    """The paper's cost model survives the process boundary: mpklink pays
    ceil(frame/chunk) client syncs per publish + one service sync per
    drain pass; mpklink_opt pays exactly one of each."""
    p = np.frombuffer(os.urandom(200 * 1024), np.uint8)
    tr = ALL_TRANSPORTS["mpklink_proc"](_echo, timeout=15.0,
                                        capacity=256 * 1024)
    try:
        s = tr.connect()
        before = s.sync_count
        s.request(p)
        # frame = 200KiB payload + header -> 4 x 64KiB chunks + 1 svc sync
        assert s.sync_count - before == 5
        s.close()
    finally:
        tr.close()
    tr = ALL_TRANSPORTS["mpklink_opt_proc"](_echo, timeout=15.0,
                                            capacity=256 * 1024)
    try:
        s = tr.connect()
        before = s.sync_count
        s.request(p)
        assert s.sync_count - before == 2           # 1 publish + 1 drain
        s.close()
    finally:
        tr.close()


def test_mpklink_proc_request_into_zero_copy():
    """request_into writes the message straight into the SHARED segment."""
    tr = ALL_TRANSPORTS["mpklink_opt_proc"](_echo, timeout=15.0)
    try:
        s = tr.connect()
        src = np.frombuffer(os.urandom(4096), np.uint8)

        def fill(dst):
            assert dst.numel() == 4096
            # the destination is the request slot's rows in the slab
            assert s._slab.data_ptr() <= dst.data_ptr() \
                < s._slab.data_ptr() + s._slab.numel() * 4
            dst.copy_(torch.from_numpy(src.copy()))
        out = s.request_into(4096, fill)
        assert _bytes(out) == bytes(src[::-1])
        s.close()
    finally:
        tr.close()


# ---------------------------------------------------------------------------
# typed errors across the boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROC_TRANSPORTS))
def test_oversized_request_is_capacity_error(name):
    tr = ALL_TRANSPORTS[name](_echo, timeout=15.0, capacity=64 * 1024)
    try:
        s = tr.connect()
        with pytest.raises(CapacityError):
            s.request(np.zeros(128 * 1024, np.uint8))
        # the session survives a refused oversized request
        p = np.frombuffer(os.urandom(100), np.uint8)
        assert _bytes(s.request(p)) == bytes(p[::-1])
        s.close()
    finally:
        tr.close()


@pytest.mark.parametrize("name", sorted(PROC_TRANSPORTS))
def test_oversized_response_is_typed_not_stranded(name):
    """A handler reply bigger than the response area must surface to the
    CALLER as CapacityError (marshalled from the child), never wedge."""
    tr = ALL_TRANSPORTS[name](H.grow, timeout=15.0, capacity=32 * 1024)
    try:
        s = tr.connect()
        with pytest.raises(CapacityError):
            s.request(np.zeros(16, np.uint8))
        s.close()
    finally:
        tr.close()


@pytest.mark.parametrize("name", NEW_TRANSPORTS)
def test_handler_exception_marshals_typed(name):
    tr = ALL_TRANSPORTS[name](H.angry, timeout=15.0)
    try:
        s = tr.connect()
        with pytest.raises(TransportError, match="wrong shape"):
            s.request(np.zeros(8, np.uint8))
        s.close()
    finally:
        tr.close()


@pytest.mark.parametrize("name", sorted(PROC_TRANSPORTS) + ["sockrpc"])
def test_slow_handler_is_response_timeout_not_crash(name):
    tr = ALL_TRANSPORTS[name](H.slow, timeout=0.15)
    try:
        s = tr.connect()
        with pytest.raises(ResponseTimeout):
            s.request(np.zeros(8, np.uint8))
        with pytest.raises(TransportError, match="poisoned"):
            s.request(np.zeros(8, np.uint8))
        s.close()
    finally:
        tr.close()


# ---------------------------------------------------------------------------
# REAL process crashes: kill -9 semantics, typed + immediate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW_TRANSPORTS)
def test_handler_crash_kills_real_process_typed_and_fast(name):
    """HandlerCrash SIGKILLs the service PROCESS; the client sees typed
    ServiceCrashed within the doorbell-EOF window, never a deadline."""
    tr = ALL_TRANSPORTS[name](H.die, timeout=30.0)
    try:
        s = tr.connect()
        t0 = time.perf_counter()
        with pytest.raises(ServiceCrashed):
            s.request(np.zeros(8, np.uint8))
        assert time.perf_counter() - t0 < 5.0, "sat out the deadline"
        if name in PROC_TRANSPORTS:
            s._proc.join(timeout=2.0)
            assert s._proc.exitcode == -signal.SIGKILL   # a real kill -9
            # a dead session refuses new work immediately, typed
            with pytest.raises(ServiceCrashed):
                s.submit(np.zeros(8, np.uint8))
        s.close()
    finally:
        tr.close()


def test_external_sigkill_with_request_in_flight_surfaces_immediately():
    """kill -9 from OUTSIDE with a request in flight: doorbell EOF turns
    the kill into ServiceCrashed within the wait slice — the client never
    sits out its (long) 30s deadline on a dead service."""
    tr = ALL_TRANSPORTS["mpklink_opt_proc"](
        functools.partial(H.slow, sleep_s=5.0), timeout=30.0)
    try:
        s = tr.connect()
        t = s.submit(np.zeros(8, np.uint8))
        s.flush()                        # child is now serving (slowly)
        time.sleep(0.2)
        assert s._proc is not None and s._proc.is_alive()
        os.kill(s._proc.pid, signal.SIGKILL)
        t0 = time.perf_counter()
        with pytest.raises(ServiceCrashed):
            s.poll(t)
        assert time.perf_counter() - t0 < 5.0
        s.close()
    finally:
        tr.close()


def test_crash_while_holding_sealed_slot_never_recycles():
    """A slot the dead service had live (published, being served) must
    never return to the arena — a fresh message must not alias rows of
    unknown provenance. The whole segment dies with the session
    instead."""
    tr = ALL_TRANSPORTS["mpklink_opt_proc"](H.die_second, timeout=5.0)
    try:
        s = tr.connect()
        first = np.full(64, 1, np.uint8)
        assert _bytes(s.request(first)) == bytes(first)
        doomed = np.full(64, 2, np.uint8)
        t = s.submit(doomed)
        s.flush()
        with pytest.raises(ServiceCrashed):
            s.poll(t)
        # the crashed ticket's slot + arena buffers stay pinned forever
        assert t in s._inflight
        slot = s._slots[t % s._nslots]
        assert int(slot[procwire._S_STATE]) != procwire._FREE
        free_lists = s.arena._free
        req_buf, resp_buf, _ = s._inflight[t]
        for lst in free_lists.values():
            for buf in lst:
                assert buf.data_ptr() != req_buf.data_ptr()
                assert buf.data_ptr() != resp_buf.data_ptr()
        # and the session refuses new submissions outright
        with pytest.raises(ServiceCrashed):
            s.submit(np.zeros(8, np.uint8))
        name = s._seg.name
        del req_buf, resp_buf, slot, free_lists
        s.close()
        assert not os.path.exists(f"/dev/shm/{name}")   # segment unlinked
    finally:
        tr.close()


# ---------------------------------------------------------------------------
# _recv_exact peer-death taxonomy (socket transports == rings)
# ---------------------------------------------------------------------------

def test_recv_exact_eof_is_service_crashed():
    """Unit: a peer closing mid-message is liveness (ServiceCrashed), not
    a generic protocol error."""
    a, b = socket.socketpair()
    try:
        a.sendall(b"ab")                 # partial: 2 of 4 requested bytes
        a.close()
        with pytest.raises(ServiceCrashed):
            _recv_exact(b, 4)
    finally:
        b.close()


def test_sockrpc_killed_server_is_service_crashed():
    """End-to-end: kill -9 the TCP RPC server mid-session; the client's
    _recv_exact EOF classifies exactly like a dead ring service."""
    tr = ALL_TRANSPORTS["sockrpc"](_echo, timeout=10.0)
    try:
        s = tr.connect()
        p = np.frombuffer(os.urandom(64), np.uint8)
        assert _bytes(s.request(p)) == bytes(p[::-1])
        tr.kill_server()
        with pytest.raises(ServiceCrashed):
            s.request(p)
        # the transport respawns its server; a fresh attempt succeeds
        assert _bytes(s.request(p)) == bytes(p[::-1])
        s.close()
    finally:
        tr.close()


def test_rest_killed_server_is_service_crashed():
    tr = ALL_TRANSPORTS["rest"](_echo, timeout=10.0)
    try:
        s = tr.connect()
        p = np.frombuffer(os.urandom(64), np.uint8)
        assert _bytes(s.request(p)) == bytes(p[::-1])
        tr.kill_server()
        with pytest.raises(ServiceCrashed):
            s.request(p)
        assert _bytes(s.request(p)) == bytes(p[::-1])
        s.close()
    finally:
        tr.close()


def test_rest_is_actually_http():
    """The REST baseline must speak real HTTP/1.1 + JSON on a real TCP
    port — not a framed socketpair in disguise."""
    import base64
    import http.client
    import json
    tr = ALL_TRANSPORTS["rest"](_echo, timeout=10.0)
    try:
        s = tr.connect()
        p = np.arange(16, dtype=np.uint8)
        s.request(p)                     # starts the server
        conn = http.client.HTTPConnection("127.0.0.1", tr.port, timeout=5.0)
        conn.request("POST", "/invoke",
                     body=json.dumps({"payload": base64.b64encode(
                         p.tobytes()).decode("ascii")}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.version == 11 and r.status == 200
        doc = json.loads(r.read())
        assert base64.b64decode(doc["result"]) == p.tobytes()[::-1]
        conn.close()
        s.close()
    finally:
        tr.close()


# ---------------------------------------------------------------------------
# credit wait clamped by the caller's budget (proc twin)
# ---------------------------------------------------------------------------

def test_proc_submit_timeout_clamps_credit_wait():
    """A full ring + submit(timeout=0.05) surfaces ResponseTimeout in
    ~0.05s even with a 30s credit window; the credit window alone still
    yields CapacityError."""
    slow = functools.partial(H.slow, sleep_s=0.6)
    tr = ALL_TRANSPORTS["shm_proc"](slow, timeout=30.0, ring_slots=2,
                                    credit_wait=30.0)
    try:
        s = tr.connect()
        for _ in range(2):               # fill both slots
            s.submit(np.zeros(8, np.uint8))
        s.flush()
        t0 = time.perf_counter()
        with pytest.raises(ResponseTimeout):
            s.submit(np.zeros(8, np.uint8), timeout=0.05)
        assert time.perf_counter() - t0 < 1.0
        s.close()
    finally:
        tr.close()
    tr = ALL_TRANSPORTS["shm_proc"](slow, timeout=30.0, ring_slots=2,
                                    credit_wait=0.08)
    try:
        s = tr.connect()
        for _ in range(2):
            s.submit(np.zeros(8, np.uint8))
        s.flush()
        t0 = time.perf_counter()
        with pytest.raises(CapacityError):
            s.submit(np.zeros(8, np.uint8))
        assert time.perf_counter() - t0 < 1.0
        s.close()
    finally:
        tr.close()


# ---------------------------------------------------------------------------
# segment lifecycle — idempotent close-with-unlink, no leaks
# ---------------------------------------------------------------------------

def test_close_is_idempotent_and_unlinks():
    tr = ALL_TRANSPORTS["mpklink_opt_proc"](_echo, timeout=10.0)
    try:
        s = tr.connect()
        p = np.frombuffer(os.urandom(256), np.uint8)
        s.request(p)
        name = s._seg.name
        assert os.path.exists(f"/dev/shm/{name}")
        s.close()
        assert not os.path.exists(f"/dev/shm/{name}")
        s.close()                        # second close: clean no-op
        s.close()
    finally:
        tr.close()


def test_close_with_live_response_view_still_unlinks():
    """A caller-held response must never pin the NAME: unlink happens at
    close regardless (the port's responses are copies, so the mapping is
    not pinned either)."""
    tr = ALL_TRANSPORTS["shm_proc"](_echo, timeout=10.0)
    try:
        s = tr.connect()
        p = np.frombuffer(os.urandom(256), np.uint8)
        out = s.request(p)
        name = s._seg.name
        s.close()
        assert not os.path.exists(f"/dev/shm/{name}")
        assert _bytes(out) == bytes(p[::-1])     # stays readable
        del out
    finally:
        tr.close()


def test_no_segment_or_tracker_leaks_100_cycles():
    """100 open/close cycles in a fresh interpreter — zero
    resource_tracker warnings, zero stderr noise, zero /dev/shm leftovers
    (including one deliberately UNCLOSED session covered by the finalizer
    backstop). The handler comes from an importable module: a child
    started by the forkserver unpickles it by name."""
    script = r"""
import os, numpy as np
from repro_torch.core import ALL_TRANSPORTS
from torch_proc_handlers import echo_same as echo

for i in range(100):
    name = ("shm_proc", "mpklink_opt_proc")[i % 2]
    tr = ALL_TRANSPORTS[name](echo, timeout=10.0, device="cpu")
    s = tr.connect()
    s.request(np.zeros(64, np.uint8))
    s.close()
    tr.close()
# one sloppy user: session never closed — the finalizer backstop unlinks
tr = ALL_TRANSPORTS["shm_proc"](echo, timeout=10.0, device="cpu")
s = tr.connect()
s.request(np.zeros(64, np.uint8))
print("CYCLES-DONE", len([f for f in os.listdir('/dev/shm')
                          if f.startswith(f'mpkt_{os.getpid()}_')]),
      "PID", os.getpid())
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=100)
    assert r.returncode == 0, r.stderr
    # while running, exactly ONE segment may be live (the unclosed one)
    assert "CYCLES-DONE 1 " in r.stdout, r.stdout
    assert "resource_tracker" not in r.stderr, r.stderr
    assert "BufferError" not in r.stderr, r.stderr
    assert "Traceback" not in r.stderr, r.stderr
    # the backstop unlinked the stray: no segment of that interpreter is
    # left (segments of other test processes running beside it are theirs)
    pid = r.stdout.split("PID")[1].split()[0]
    assert [f for f in _leftover_segments()
            if f.startswith(f"{procwire.SEGMENT_PREFIX}{pid}_")] == []


# ---------------------------------------------------------------------------
# gateway integration: named services over process-backed transports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROC_TRANSPORTS) + ["sockrpc"])
def test_gateway_over_process_transport(name):
    gw = ServiceGateway(name, transport_kwargs={"timeout": 20.0})
    gw.register_service("wordcount", wordcount_handler)
    gw.start()
    try:
        c = gw.connect("cli")
        for i in range(4):
            n = 5 + i
            assert parse_count(c.call("wordcount",
                                      make_text(n, seed=i))) == n
    finally:
        gw.close()


def test_gateway_heals_killed_service_process():
    """The full process-crash recovery story: a crashing handler SIGKILLs
    the service child (typed ServiceCrashed); the PARENT restarts the
    service (factory swap + epoch bump — a child's snapshot can't see live
    control-plane changes); a retrying client's heal then starts a FRESH
    child whose snapshot carries the restarted handler AND the new
    epoch."""
    gw = ServiceGateway("mpklink_opt_proc",
                        transport_kwargs={"timeout": 20.0})
    gw.register_service("wc", H.flaky, factory=H.wordcount_factory)
    gw.start()
    try:
        c = gw.connect("cli", retries=2)
        with pytest.raises(ServiceCrashed):
            c.call("wc", make_text(6, seed=0))     # every new child dies
        gw.restart_service("wc")                   # operator/supervisor heal
        assert parse_count(c.call("wc", make_text(6, seed=1))) == 6
    finally:
        gw.close()
