"""The port's process transports held against the reference's in one
process: the wire constants, frames sealed in the port's service child
bit for bit against the reference's ``framing.seal_into`` of the same
bytes, seed and sequence, and the REST / sockrpc baselines crossed both
ways (a port session against the reference's server, a reference session
against the port's). A handler that does not pickle is refused before any
child starts."""
import multiprocessing
import os

import numpy as np
import pytest
import torch

import torch_proc_handlers as H
from repro.core import framing as ref_framing
from repro.core import procwire as ref_pw
from repro_torch.core import ServiceGateway, procwire
from repro_torch.core.wordcount import make_text, parse_count

pytestmark = pytest.mark.proc


@pytest.fixture(autouse=True, scope="module")
def _port_proc_hygiene(request):
    yield
    H.proc_hygiene(request.module.__name__)


@pytest.fixture(autouse=True)
def _bounded():
    with H.bounded(120):
        yield


def test_wire_constants_match_the_reference():
    names = [n for n in dir(ref_pw)
             if n.startswith(("PROC_MAGIC", "PROC_VERSION", "PROC_CTRL",
                              "PROC_SLOT", "_W_", "_S_", "_MODE_", "_ERR_"))
             or n in ("_FREE", "_STAGED", "_PUBLISHED", "_DONE", "_DROPPED")]
    assert len(names) >= 31
    for n in names:
        assert getattr(procwire, n) == getattr(ref_pw, n), n
    # the launch words the port adds lie in words the reference leaves free
    assert procwire._W_LAUNCH0 > max(getattr(ref_pw, n) for n in names
                                     if n.startswith("_W_"))
    assert sorted(procwire.PROC_TRANSPORTS) == sorted(ref_pw.PROC_TRANSPORTS)
    assert sorted(procwire.BASELINE_TRANSPORTS) \
        == sorted(ref_pw.BASELINE_TRANSPORTS)


def _frame_at(s, b: int, off_word: int, rows_word: int) -> np.ndarray:
    w = s._w
    off, rows = w[b + off_word], w[b + rows_word]
    return s._slab[off:off + rows].numpy().copy()


@pytest.mark.parametrize("nbytes", [1, 300, 5000])
def test_child_sealed_frames_match_the_reference(nbytes):
    """The request the parent seals into the slab and the response the
    child seals back are, word for word, the reference's ``seal_into`` of
    the same bytes under the same seed and sequence."""
    tr = procwire.ProcMPKLinkOptTransport(H.echo, timeout=15.0, device="cpu")
    try:
        s = tr.connect()
        for k in range(3):
            p = np.frombuffer(os.urandom(nbytes), np.uint8)
            t = s._tickets
            out = s.request(p)
            assert H.host(out).tobytes() == p[::-1].tobytes()
            b = procwire.PROC_CTRL_WORDS + (t % s._nslots) \
                * procwire.PROC_SLOT_WORDS
            seq = s._w[b + procwire._S_SEQ]
            assert seq == k
            req = _frame_at(s, b, procwire._S_REQ_OFF, procwire._S_REQ_ROWS)
            resp = _frame_at(s, b, procwire._S_RESP_OFF,
                             procwire._S_RESP_ROWS)
            want_req = np.zeros_like(req)
            want_resp = np.zeros_like(resp)
            assert ref_framing.seal_into(want_req, p, seed=s.seed,
                                         seq=seq) == req.shape[0]
            assert ref_framing.seal_into(want_resp, p[::-1].copy(),
                                         seed=s.seed, seq=seq) \
                == resp.shape[0]
            np.testing.assert_array_equal(req, want_req)
            np.testing.assert_array_equal(resp, want_resp)
            # and the reference's guard accepts the child's frame
            got = ref_framing.verify_view(resp, seed=s.seed, expect_seq=seq)
            assert got.tobytes() == p[::-1].tobytes()
        s.close()
    finally:
        tr.close()


def _host_bytes(out) -> bytes:
    return H.host(out).tobytes()


@pytest.mark.parametrize("name", ["rest", "sockrpc"])
def test_port_session_against_the_reference_server(name):
    ref = ref_pw.BASELINE_TRANSPORTS[name](H.echo, timeout=10.0)
    port = procwire.BASELINE_TRANSPORTS[name](H.echo, timeout=10.0,
                                              device="cpu")
    try:
        ref._ensure_server()
        port.port = ref.port
        port._ensure_server = lambda: None      # talk to the reference's
        s = port.connect()
        for n in (1, 300, 70000):
            p = np.frombuffer(os.urandom(n), np.uint8)
            assert _host_bytes(s.request(p)) == p[::-1].tobytes()
        assert port._server_proc is None        # no port server started
        s.close()
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("name", ["rest", "sockrpc"])
def test_reference_session_against_the_port_server(name):
    port = procwire.BASELINE_TRANSPORTS[name](H.echo, timeout=10.0,
                                              device="cpu")
    ref = ref_pw.BASELINE_TRANSPORTS[name](H.echo, timeout=10.0)
    try:
        port._ensure_server()
        ref.port = port.port
        ref._ensure_server = lambda: None
        s = ref.connect()
        for n in (1, 300, 70000):
            p = np.frombuffer(os.urandom(n), np.uint8)
            assert bytes(s.request(p)) == p[::-1].tobytes()
        # a typed error crosses too
        s.close()
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("name", ["rest", "sockrpc"])
def test_typed_errors_cross_the_baselines_both_ways(name):
    from repro.core.transports import TransportError as RefError
    from repro_torch.core.transports import TransportError
    port = procwire.BASELINE_TRANSPORTS[name](H.angry, timeout=10.0,
                                              device="cpu")
    ref = ref_pw.BASELINE_TRANSPORTS[name](H.angry, timeout=10.0)
    try:
        port._ensure_server()
        ref._ensure_server()
        port_port, ref_port = port.port, ref.port
        port.port, ref.port = ref_port, port_port
        port._ensure_server = ref._ensure_server = lambda: None
        with pytest.raises(TransportError, match="wrong shape"):
            port.connect().request(np.zeros(8, np.uint8))
        with pytest.raises(RefError, match="wrong shape"):
            ref.connect().request(np.zeros(8, np.uint8))
    finally:
        ref.close()
        port.close()


def _closure_handler():
    k = 3

    def handler(req):
        return H.host(req)[:k]
    return handler


@pytest.mark.parametrize("name", ["shm_proc", "mpklink_proc",
                                  "mpklink_opt_proc", "rest", "sockrpc"])
def test_unpicklable_handler_refused_before_any_child_starts(name):
    from repro_torch.core import ALL_TRANSPORTS
    tr = ALL_TRANSPORTS[name](_closure_handler(), timeout=10.0, device="cpu")
    try:
        s = tr.connect()
        with pytest.raises(procwire.HandlerNotPicklable,
                           match="handler.*forkserver"):
            s.request(np.zeros(8, np.uint8))
        assert getattr(s, "_proc", None) is None
        assert getattr(tr, "_server_proc", None) is None
        assert multiprocessing.active_children() == []
        s.close()
    finally:
        tr.close()


def test_gateway_with_unpicklable_service_refused_before_its_child():
    """A proc gateway sends itself to its service process: a lambda
    service handler makes the whole gateway unpicklable, refused typed in
    the parent; module-level handlers serve."""
    gw = ServiceGateway("mpklink_opt_proc", device="cpu",
                        transport_kwargs={"timeout": 20.0})
    gw.register_service("wc", lambda req: req)
    gw.start()
    try:
        c = gw.connect("cli")
        with pytest.raises(procwire.HandlerNotPicklable):
            c.call("wc", make_text(3, seed=0))
        assert multiprocessing.active_children() == []
    finally:
        gw.close()
    gw = ServiceGateway("mpklink_opt_proc", device="cpu",
                        transport_kwargs={"timeout": 20.0})
    gw.register_service("wc", H.wordcount)
    gw.start()
    try:
        assert parse_count(gw.connect("cli").call(
            "wc", make_text(7, seed=1))) == 7
    finally:
        gw.close()


def test_cuda_process_transport_without_a_card_raises():
    """The entry points run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        procwire.ProcMPKLinkOptTransport(H.echo)
