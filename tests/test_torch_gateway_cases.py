"""The reference's gateway cases run against the port's gateway on the CPU:
the gateway cases of ``tests/test_gateway.py`` and the ``test_gateway_*``
cases of ``tests/test_batching.py``, under their own names. Payloads and
responses are tensors here (CPU), so the checks read them with
``np.asarray``. ``test_gateway_batch_crash_handler_mid_batch_typed_and_bounded``
needs ``faultwire`` and waits for it (ROADMAP.md, queue 1, item 3)."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import TRANSPORTS, AccessViolation, framing
from repro_torch.core import ServiceGateway as _ServiceGateway
from repro_torch.core.gateway import (GW_MAGIC, _BOK, _OK, _ROUTE_BYTES,
                                      _batch_route)
from repro_torch.core.transports import TransportError, _raise_remote
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


def _bytes(resp) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(resp)).view(np.uint8).reshape(-1)


def _env(route: np.ndarray, frames) -> np.ndarray:
    return np.concatenate([route] + [np.asarray(f).reshape(-1).view(np.uint8)
                                     for f in frames])


def _reverse(req):
    return np.ascontiguousarray(np.asarray(req)[::-1])


def _make_gateway(transport: str):
    gw = ServiceGateway(transport)
    gw.register_service("wordcount", wordcount_handler)
    gw.register_service("reverse", _reverse)
    return gw.start()


# ---------------------------------------------------------------------------
# tests/test_gateway.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRANSPORTS))
def test_gateway_concurrent_two_services(name):
    """N client threads hammer two services at once over each transport;
    every response is cross-checked against its own request."""
    gw = _make_gateway(name)
    n_clients, reps = 6, 3
    errors = []

    def worker(i):
        try:
            c = gw.connect(f"client-{i}")
            for j in range(reps):
                n = 40 * (i + 1) + j
                assert parse_count(c.call("wordcount", make_text(n, seed=j))) == n
                arr = np.arange(i * 10, i * 10 + 9, dtype=np.int32)
                rev = c.call("reverse", arr)
                np.testing.assert_array_equal(np.asarray(rev), arr[::-1])
            c.close()
        except Exception as e:          # surfaced below
            errors.append((i, repr(e)))

    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not errors, errors
        assert gw.stats["responses"] == n_clients * reps * 2
        assert gw.stats["macs_verified"] == n_clients * reps * 2
        assert gw.stats["rejected"] == 0
    finally:
        gw.close()


def test_gateway_foreign_key_rejected():
    """A client holding a key for service A gets AccessViolation/guard
    rejection from service B — never B's (or anyone's) data."""
    gw = _make_gateway("mpklink_opt")
    gw.register_service("secret", lambda r: r, allow={"vip"})
    try:
        vip = gw.connect("vip")
        vip.open("secret")
        intruder = gw.connect("intruder")

        # control plane: the CA refuses to issue the key at all
        with pytest.raises(AccessViolation):
            intruder.call("secret", np.arange(4, dtype=np.int32))

        # data plane: forge an envelope addressed to 'secret' using the
        # intruder's wordcount channel key/seed (the foreign-key attack)
        chan_wc = intruder.open("wordcount")
        sid_secret = vip._channels["secret"].sid
        frame = framing.build_frame(np.arange(4, dtype=np.int32),
                                    seed=chan_wc.seed, seq=0, device="cpu")
        env = _env(np.array([GW_MAGIC, sid_secret, intruder.cid, 0], "<u4")
                   .view(np.uint8), [frame])
        resp = _bytes(intruder._session.request(env))
        route = resp[:_ROUTE_BYTES].view("<u4")
        assert int(route[1]) == 1                  # error status, no data
        with pytest.raises((AccessViolation, framing.FrameError)):
            _raise_remote(resp[_ROUTE_BYTES:
                               _ROUTE_BYTES + int(route[3])].tobytes())

        # data plane: right service id, wrong MAC seed → guard rejection
        chan = vip._channels["secret"]
        bad = framing.build_frame(np.arange(4, dtype=np.int32),
                                  seed=chan.seed ^ 0xDEAD, seq=chan.seq,
                                  device="cpu")
        env2 = _env(np.array([GW_MAGIC, chan.sid, vip.cid, 0], "<u4")
                    .view(np.uint8), [bad])
        resp2 = _bytes(vip._session.request(env2))
        route2 = resp2[:_ROUTE_BYTES].view("<u4")
        assert int(route2[1]) == 1
        with pytest.raises(framing.FrameError):
            _raise_remote(resp2[_ROUTE_BYTES:
                                _ROUTE_BYTES + int(route2[3])].tobytes())
        assert gw.stats["rejected"] == 2
    finally:
        gw.close()


def test_gateway_revocation():
    gw = _make_gateway("mpklink_opt")
    try:
        a, b = gw.connect("alice"), gw.connect("bob")
        assert parse_count(a.call("wordcount", make_text(10, seed=0))) == 10
        assert parse_count(b.call("wordcount", make_text(11, seed=0))) == 11
        gw.revoke(a, "wordcount")
        # epoch bumped: bob's cached key is stale, but he is still certified
        # — call() re-keys through the CA transparently and succeeds
        epoch_key = b._channels["wordcount"].client_key
        assert parse_count(b.call("wordcount", make_text(12, seed=0))) == 12
        assert b._channels["wordcount"].client_key is not epoch_key
        # a BANNED client cannot re-key: the CA refuses the certificate
        gw.ca.revoke_service("alice")
        with pytest.raises(AccessViolation):
            a.call("wordcount", make_text(13, seed=0))
    finally:
        gw.close()


def test_gateway_handler_errors_propagate():
    def boom(req):
        raise ValueError("handler exploded")

    gw = ServiceGateway("uds")
    gw.register_service("boom", boom)
    gw.start()
    try:
        c = gw.connect("c")
        with pytest.raises(TransportError):
            c.call("boom", np.arange(3, dtype=np.int32))
        # the session survives the error — next call works
        gw.register_service("ok", lambda r: r)
        np.testing.assert_array_equal(
            np.asarray(c.call("ok", np.arange(3, dtype=np.int32))),
            np.arange(3, dtype=np.int32))
    finally:
        gw.close()


def test_ca_refuses_reregistration_of_revoked_identity():
    """A ban survives reconnects: gw.connect() under a revoked name raises
    instead of minting a fresh verified certificate."""
    gw = _make_gateway("uds")
    try:
        mallory = gw.connect("mallory")
        assert parse_count(mallory.call("wordcount", make_text(5, seed=0))) == 5
        gw.ca.revoke_service("mallory")
        with pytest.raises(AccessViolation, match="revoked"):
            gw.connect("mallory")
    finally:
        gw.close()


def test_client_results_are_owned_snapshots():
    """GatewayClient results must not alias transport storage: an aliased
    r1 would silently flip to r2's bytes when the next call reuses it."""
    gw = ServiceGateway("mpklink_opt")
    gw.register_service("echo", lambda req: req)
    gw.start()
    try:
        c = gw.connect("snap")
        a = np.arange(64, dtype=np.uint8)
        b = np.full(64, 7, np.uint8)
        r1 = c.call("echo", a)
        expect = np.asarray(r1).copy()
        r2 = c.call("echo", b)                      # reuses the region
        np.testing.assert_array_equal(np.asarray(r1), expect)
        np.testing.assert_array_equal(np.asarray(r2), b)
        # batch and scatter results carry the same ownership guarantee
        rb = c.call_batch("echo", [a, b])
        rm = c.call_many([("echo", a), ("echo", b)])
        snaps = [np.asarray(r).copy() for r in rb + rm]
        c.call("echo", np.full(64, 99, np.uint8))
        for got, r in zip(snaps, rb + rm):
            np.testing.assert_array_equal(np.asarray(r), got)
        assert all(r._base is None for r in [r1, r2] + rb + rm)
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# tests/test_batching.py: the gateway batch envelope
# ---------------------------------------------------------------------------

def _gw(transport="mpklink_opt", **kw):
    gw = ServiceGateway(transport, **kw)
    gw.register_service("wordcount", wordcount_handler)
    return gw.start()


@pytest.mark.parametrize("name", ["mpklink_opt", "uds", "shm"])
def test_gateway_call_batch_roundtrip(name):
    gw = _gw(name)
    try:
        c = gw.connect("batcher")
        ns = [2, 30, 400]
        outs = c.call_batch("wordcount", [make_text(n, seed=n) for n in ns])
        assert [parse_count(o) for o in outs] == ns
        # interleaves with single calls on the same channel sequence
        assert parse_count(c.call("wordcount", make_text(8, seed=0))) == 8
        outs = c.call_batch("wordcount", [make_text(9, seed=0)])
        assert parse_count(outs[0]) == 9
        assert gw.stats["macs_verified"] == 5
        assert c.macs_verified == 5
        assert gw.stats["rejected"] == 0
        c.close()
    finally:
        gw.close()


def test_gateway_batch_handler_errors_are_per_item():
    def picky(req):
        if np.asarray(req).size == 1:
            raise ValueError("bad apple")
        return np.asarray(req)

    gw = ServiceGateway("mpklink_opt")
    gw.register_service("picky", picky, failure_threshold=100)
    gw.start()
    try:
        c = gw.connect("x")
        res = c.call_batch(
            "picky", [np.arange(4, dtype=np.int32), np.zeros(1, np.int32),
                      np.arange(3, dtype=np.int32)], return_exceptions=True)
        assert isinstance(res[1], TransportError)
        assert "bad apple" in str(res[1])
        np.testing.assert_array_equal(np.asarray(res[0]),
                                      np.arange(4, dtype=np.int32))
        np.testing.assert_array_equal(np.asarray(res[2]),
                                      np.arange(3, dtype=np.int32))
        # without return_exceptions the first per-item error is raised after
        # the batch drained — and the channel sequence stays aligned
        with pytest.raises(TransportError, match="bad apple"):
            c.call_batch("picky", [np.zeros(1, np.int32)])
        out = c.call_batch("picky", [np.arange(2, dtype=np.int32)])
        np.testing.assert_array_equal(np.asarray(out[0]),
                                      np.arange(2, dtype=np.int32))
    finally:
        gw.close()


def test_gateway_batch_corrupt_mac_mid_batch():
    """Forged batch envelope with one tampered frame: the gateway answers
    item-by-item — OK, FrameError blob, OK — and the wire count proves only
    the intact frames were MAC-verified."""
    gw = _gw()
    try:
        c = gw.connect("m")
        chan = c.open("wordcount")
        frames = framing.seal_batch(
            [make_text(n, seed=n) for n in (3, 4, 5)],
            seed=chan.seed, start_seq=chan.seq, device="cpu")
        frames[1] = frames[1].clone()
        frames[1].view(torch.int32)[0, 11] ^= 1 << 3
        env = _env(_batch_route(chan.sid, c.cid, 3), frames)
        resp = _bytes(c._session.request(env))
        route = resp[:_ROUTE_BYTES].view("<u4")
        assert int(route[0]) == GW_MAGIC and int(route[1]) == _BOK
        statuses, ofs = [], _ROUTE_BYTES
        for _ in range(3):
            ih = resp[ofs: ofs + _ROUTE_BYTES].view("<u4")
            statuses.append(int(ih[1]))
            nb = int(ih[2])
            ofs += _ROUTE_BYTES + nb + ((-nb) % 4)
        assert statuses == [_OK, 1, _OK]
        assert gw.stats["macs_verified"] == 2
        assert gw.stats["rejected"] == 1
        chan.seq += 3                       # our hand-rolled envelope's seqs
        assert parse_count(c.call("wordcount", make_text(6, seed=0))) == 6
    finally:
        gw.close()


def test_gateway_batch_rekeys_after_epoch_bump():
    """A revocation elsewhere on the domain bumps the epoch; a
    still-certified batch client re-keys through the CA transparently —
    the same recovery contract call() has."""
    gw = _gw()
    try:
        a, b = gw.connect("alice"), gw.connect("bob")
        assert parse_count(a.call("wordcount", make_text(3, seed=0))) == 3
        assert parse_count(
            b.call_batch("wordcount", [make_text(4, seed=0)])[0]) == 4
        old_key = b._channels["wordcount"].client_key
        gw.revoke(a, "wordcount")           # epoch bump stales bob's key
        outs = b.call_batch("wordcount",
                            [make_text(6, seed=0), make_text(7, seed=0)])
        assert [parse_count(o) for o in outs] == [6, 7]
        assert b._channels["wordcount"].client_key is not old_key
    finally:
        gw.close()


def test_gateway_unframeable_handler_output_never_desyncs():
    """Response sealing happens after the sequence advance, so it must
    never fail: rank>4 handler output is flattened to bytes (a typed
    answer), and the channel stays aligned for both call paths."""
    gw = ServiceGateway("mpklink_opt")
    gw.register_service("r5", lambda r: np.zeros((2, 2, 2, 2, 2), np.int32))
    gw.register_service("wordcount", wordcount_handler)
    gw.start()
    try:
        c = gw.connect("x")
        out = c.call_batch("r5", [np.arange(3, dtype=np.int32)])[0]
        assert out.dtype == torch.uint8 and out.numel() == 32 * 4
        c.call("r5", np.arange(3, dtype=np.int32))
        assert parse_count(c.call("wordcount", make_text(5, seed=0))) == 5
    finally:
        gw.close()


def test_gateway_batch_whole_envelope_rejections_are_typed():
    gw = _gw()
    try:
        c = gw.connect("n")
        chan = c.open("wordcount")
        # unknown service id → AccessViolation, sequence NOT consumed
        frames = framing.seal_batch([make_text(2, seed=0)],
                                    seed=chan.seed, start_seq=chan.seq,
                                    device="cpu")
        env = _env(_batch_route(0x7FFF, c.cid, 1), frames)
        resp = _bytes(c._session.request(env))
        route = resp[:_ROUTE_BYTES].view("<u4")
        assert int(route[1]) == 1
        with pytest.raises(AccessViolation):
            _raise_remote(resp[_ROUTE_BYTES:
                               _ROUTE_BYTES + int(route[3])].tobytes())
        # channel still aligned: the real batch path works
        outs = c.call_batch("wordcount", [make_text(5, seed=0)])
        assert parse_count(outs[0]) == 5
    finally:
        gw.close()
