"""The port's gateway speaks the reference's wire format, bit for bit.

The same services are registered and the same clients connected, in the
same order, in a reference ``ServiceGateway`` and in the port's (on the
CPU), so the CA's key material, the channel seeds and the id counters
agree. Each client's transport session is replaced by a crossed wire: the
envelope the reference client stages goes through the PORT's ``_dispatch``
and the port client's through the REFERENCE's. Every request envelope and
every response envelope must be equal byte for byte across the packages,
and each client must accept the other package's responses. This covers
single, batch and scatter envelopes, lane-12 priorities, per-item and
whole-envelope error blobs (one of which puts the next frame off a 16-byte
boundary), and hand-sealed envelopes with lane-10 deadlines."""
import numpy as np
import pytest
import torch

from repro.core import ServiceGateway as JServiceGateway
from repro.core import framing as jframing
from repro.core import gateway as jgateway
from repro.core.wordcount import make_text as jmake_text
from repro.core.wordcount import wordcount_handler as jwordcount_handler

from repro_torch.core import ServiceGateway, framing
from repro_torch.core import gateway
from repro_torch.core.transports import TransportError
from repro_torch.core.wordcount import wordcount_handler


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The gateway's tensors are tiny: one intra-op thread a worker keeps
    its latencies (which the routers and breakers act on) steady when the
    tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _picky(req):
    """Echo, except that a payload starting with 13 fails typed (its error
    blob is 44 bytes, so a frame after it starts 12 bytes past a 16-byte
    boundary)."""
    if int(np.asarray(req).reshape(-1)[0]) == 13:
        raise ValueError("unlucky thirteen")
    return req


def _boom(req):
    raise ValueError("handler exploded")


class _Wire:
    """A session stand-in: ``request_into`` stages the envelope as the
    calling client's package does, records it, and hands it to ``dispatch``
    (the OTHER package's gateway)."""

    def __init__(self, dispatch, port_side: bool):
        self.dispatch, self.port_side = dispatch, port_side
        self.sent, self.got = [], []

    def request_into(self, nbytes, fill, timeout=None):
        if self.port_side:
            buf = torch.empty(nbytes, dtype=torch.uint8)
            fill(buf)
            env = buf.numpy().copy()
            resp = self.dispatch(env)                       # reference
            resp = np.ascontiguousarray(np.asarray(resp)).view(np.uint8)
            out = torch.from_numpy(resp.reshape(-1).copy())
        else:
            buf = np.empty(nbytes, np.uint8)
            fill(buf)
            env = buf.copy()
            resp = self.dispatch(torch.from_numpy(env.copy()))   # port
            out = resp.numpy().reshape(-1).copy()
        self.sent.append(env.tobytes())
        self.got.append(np.asarray(out).tobytes())
        return out


class _Pair:
    """A reference gateway and a port gateway with the same services and
    the same clients, their wires crossed."""

    SERVICES = ("echo", "wc", "picky", "boom", "cohort")

    def __init__(self, clients=("alice", "bob")):
        self.ref = JServiceGateway("mpklink_opt")
        self.port = ServiceGateway("mpklink_opt", device="cpu")
        for gw, wc in ((self.ref, jwordcount_handler),
                       (self.port, wordcount_handler)):
            gw.register_service("echo", lambda r: r)
            gw.register_service("wc", wc)
            gw.register_service("picky", _picky)
            gw.register_service("boom", _boom)
            gw.register_service("cohort", lambda r: r,
                                batch_handler=lambda rs: list(rs))
        self.clients = {}
        for name in clients:
            rc, pc = self.ref.connect(name), self.port.connect(name)
            rc._session = _Wire(self.port._dispatch, port_side=False)
            pc._session = _Wire(self.ref._dispatch, port_side=True)
            for svc in self.SERVICES:       # each wire reaches the other
                rc.open(svc)                # package's gateway: open every
                pc.open(svc)                # channel on both first
            self.clients[name] = (rc, pc)

    def both(self, name, fn):
        """Run ``fn(client)`` with each package's client; the envelopes and
        responses of the two runs must agree byte for byte. → (reference
        result, port result)."""
        rc, pc = self.clients[name]
        n_r, n_p = len(rc._session.sent), len(pc._session.sent)
        out_r, out_p = fn(rc), fn(pc)
        assert rc._session.sent[n_r:] == pc._session.sent[n_p:]
        assert rc._session.got[n_r:] == pc._session.got[n_p:]
        assert len(rc._session.sent) > n_r
        return out_r, out_p

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.fixture
def pair():
    p = _Pair()
    yield p
    p.close()


def _same(r, p):
    """A reference result and a port result carry the same bytes."""
    if isinstance(r, BaseException):
        assert type(p).__name__ == type(r).__name__ and str(p) == str(r)
        return
    assert isinstance(p, torch.Tensor)
    assert np.asarray(r).tobytes() == p.numpy().tobytes()


def test_channel_seeds_agree(pair):
    for name in ("alice", "bob"):
        rc, pc = pair.clients[name]
        assert rc.cid == pc.cid
        for svc in _Pair.SERVICES:
            assert rc.open(svc).seed == pc.open(svc).seed
            assert rc.open(svc).sid == pc.open(svc).sid


@pytest.mark.parametrize("payload", [
    np.arange(5, dtype=np.int32),
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.arange(700, dtype=np.int32),                 # a frame of 7 rows
    np.zeros(0, np.uint8),
    np.arange(2 * 3 * 2 * 2, dtype=np.int64).reshape(2, 3, 2, 2),
])
def test_single_envelopes_bit_for_bit(pair, payload):
    for service in ("echo", "picky") if payload.size else ("echo",):
        r, p = pair.both("alice", lambda c: c.call(service, payload))
        _same(r, p)


@pytest.mark.parametrize("priority", [jframing.PRIO_HIGH, jframing.PRIO_BULK,
                                      jframing.PRIO_NORMAL])
def test_priority_lane_bit_for_bit(pair, priority):
    assert priority == framing.PRIO_HIGH or priority in (framing.PRIO_BULK,
                                                         framing.PRIO_NORMAL)
    text = jmake_text(30, seed=4)
    r, p = pair.both("bob", lambda c: c.call("wc", text, priority=priority))
    _same(r, p)
    rc, pc = pair.clients["bob"]
    env = np.frombuffer(pc._session.sent[-1], "<u4")
    assert env[4 + framing.PRIORITY_LANE] == priority


def _caught(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except Exception as e:          # the typed error is the result
        return e


def test_single_error_envelopes_bit_for_bit(pair):
    pay = np.asarray([13, 1, 2], np.int32)
    for service in ("boom", "picky"):
        r, p = pair.both("alice", lambda c: _caught(c.call, service, pay))
        assert isinstance(p, TransportError)
        _same(r, p)
    # the channel stays usable on both sides
    r, p = pair.both("alice", lambda c: c.call("picky", pay[1:]))
    _same(r, p)


def test_batch_envelopes_bit_for_bit(pair):
    pays = [np.arange(3, dtype=np.int32), np.arange(700, dtype=np.int32),
            np.asarray([9, 9], np.uint8), np.zeros((2, 5), np.float32)]
    r, p = pair.both("alice", lambda c: c.call_batch("echo", pays))
    for a, b in zip(r, p):
        _same(a, b)
    r, p = pair.both("bob", lambda c: c.call_batch(
        "cohort", pays, return_exceptions=True))
    for a, b in zip(r, p):
        _same(a, b)


def test_batch_error_item_misaligns_the_next_frame(pair):
    """An error blob padded to 4 bytes puts the next item's frame off a
    16-byte boundary: the wire keeps it there, and the port's client
    copies that frame to an aligned tensor before verifying it."""
    pays = [np.asarray([13, 0], np.int32), np.arange(6, dtype=np.int32),
            np.asarray([13, 1], np.int32), np.arange(600, dtype=np.int32)]
    r, p = pair.both("alice", lambda c: c.call_batch(
        "picky", pays, return_exceptions=True))
    for a, b in zip(r, p):
        _same(a, b)
    assert isinstance(p[0], TransportError) and isinstance(p[2], TransportError)
    np.testing.assert_array_equal(p[1].numpy(), pays[1])
    np.testing.assert_array_equal(p[3].numpy(), pays[3])
    resp = np.frombuffer(pair.clients["alice"][1]._session.got[-1], np.uint8)
    words = resp.view("<u4")
    first_blob = int(words[4 + 2])                 # item 0's byte_len
    frame_ofs = 16 + 16 + first_blob + (-first_blob) % 4 + 16
    assert frame_ofs % 16 != 0, "the case must put a frame off 16 bytes"
    # the carve itself: a misaligned slice comes back aligned
    raw = torch.from_numpy(resp.copy())
    nb = int(np.frombuffer(resp[frame_ofs - 16: frame_ofs].tobytes(), "<u4")[2])
    f = gateway._frame_view(raw, frame_ofs, nb)
    assert f.data_ptr() % 16 == 0 and f.shape[1] == framing.LANES
    assert f.numpy().tobytes() == resp[frame_ofs: frame_ofs + nb].tobytes()


def test_scatter_envelopes_bit_for_bit(pair):
    text = jmake_text(20, seed=9)
    items = [("echo", np.arange(4, dtype=np.int32)), ("wc", text),
             ("picky", np.asarray([13], np.int32)),
             ("echo", np.arange(300, dtype=np.int32)),
             ("boom", np.asarray([1], np.int32)),
             ("cohort", np.asarray([5, 6], np.int32)),
             ("cohort", np.asarray([7], np.int32)),
             ("picky", np.asarray([2, 3], np.int32))]
    for _ in range(2):                              # sequences advance alike
        r, p = pair.both("bob", lambda c: c.call_many(
            items, return_exceptions=True))
        for a, b in zip(r, p):
            _same(a, b)
    # a replay with the same tokens is answered from the dedup window
    rc, pc = pair.clients["bob"]
    toks_r, toks_p = rc.mint_tokens(3), pc.mint_tokens(3)
    assert toks_r == toks_p
    few = items[:2] + items[3:4]
    r1 = rc.call_many(few, tokens=toks_r)
    p1 = pc.call_many(few, tokens=toks_p)
    for a, b in zip(r1, p1):
        _same(a, b)
    deduped = pair.port.stats["deduped"], pair.ref.stats["deduped"]
    rc._channels["echo"].seq -= 2                   # the lost-response replay
    rc._channels["wc"].seq -= 1
    pc._channels["echo"].seq -= 2
    pc._channels["wc"].seq -= 1
    r2 = rc.call_many(few, tokens=toks_r)
    p2 = pc.call_many(few, tokens=toks_p)
    for a, b, c in zip(r2, p2, p1):
        _same(a, b)
        _same(np.asarray(a), c)
    assert pair.port.stats["deduped"] == deduped[0] + 3
    assert pair.ref.stats["deduped"] == deduped[1] + 3
    assert rc._session.sent[-1] == pc._session.sent[-1]
    assert rc._session.got[-1] == pc._session.got[-1]


def _hand_sealed(pair, name, service, payload, deadline_us, priority=0):
    """One single envelope sealed by each package's ``_seal_envelope`` with
    a fixed lane-10 word, dispatched by the OTHER package's gateway."""
    rc, pc = pair.clients[name]
    rch, pch = rc.open(service), pc.open(service)
    renv = jgateway._seal_envelope(
        [jgateway.GW_MAGIC, rch.sid, rc.cid, 0], payload, seed=rch.seed,
        seq=rch.seq, mac_impl=pair.ref._mac, deadline_us=deadline_us, priority=priority)
    penv = gateway._seal_envelope(
        [gateway.GW_MAGIC, pch.sid, pc.cid, 0], payload, seed=pch.seed,
        seq=pch.seq, device="cpu", deadline_us=deadline_us, priority=priority)
    assert np.asarray(renv).tobytes() == penv.numpy().tobytes()
    resp_p = pair.port._dispatch(torch.from_numpy(np.asarray(renv).copy()))
    resp_r = pair.ref._dispatch(penv.numpy().copy())
    assert np.asarray(resp_r).tobytes() == resp_p.numpy().tobytes()
    rch.seq += 1
    pch.seq += 1
    return resp_p


def test_deadline_lane_bit_for_bit(pair):
    resp = _hand_sealed(pair, "alice", "echo", np.arange(9, dtype=np.int32),
                        deadline_us=5_000_000, priority=framing.PRIO_HIGH)
    assert int(resp[:16].view(torch.int32)[1]) == 0            # served
    resp = _hand_sealed(pair, "alice", "echo", np.arange(9, dtype=np.int32),
                        deadline_us=1)
    words = resp[:16].view(torch.int32).tolist()
    assert words[1] == 1                                       # error
    with pytest.raises(TransportError, match="deadline expired"):
        from repro_torch.core.transports import _raise_remote
        _raise_remote(resp[16:16 + words[3]].numpy().tobytes())


def test_batch_deadlines_bit_for_bit(pair):
    """A batch envelope whose frames carry lane-10 words: a live item is
    served, an expired one gets its typed error in place."""
    rc, pc = pair.clients["bob"]
    rch, pch = rc.open("echo"), pc.open("echo")
    pays = [np.arange(4, dtype=np.int32), np.arange(5, dtype=np.int32),
            np.arange(6, dtype=np.int32)]
    dls = [0, 1, 5_000_000]
    rows = [jframing.frame_rows(p.nbytes) for p in pays]
    renv = np.zeros(16 + 512 * sum(rows), np.uint8)
    renv[:16] = jgateway._batch_route(rch.sid, rc.cid, 3)
    u = renv[16:].view("<u4").reshape(-1, 128)
    bufs, r0 = [], 0
    for r in rows:
        bufs.append(u[r0:r0 + r])
        r0 += r
    jframing.seal_into_batch(bufs, pays, seed=rch.seed,
                             seqs=[rch.seq + i for i in range(3)],
                             deadlines_us=dls)
    penv = torch.zeros(16 + 512 * sum(rows), dtype=torch.uint8)
    penv[:16] = torch.from_numpy(gateway._batch_route(pch.sid, pc.cid, 3))
    pb, r0 = [], 0
    for r in rows:
        pb.append(penv[16 + 512 * r0: 16 + 512 * (r0 + r)].view(torch.uint32)
                  .reshape(r, 128))
        r0 += r
    framing.seal_into_batch(pb, pays, seed=pch.seed,
                            seqs=[pch.seq + i for i in range(3)],
                            deadlines_us=dls)
    assert renv.tobytes() == penv.numpy().tobytes()
    resp_p = pair.port._dispatch(torch.from_numpy(renv.copy()))
    resp_r = pair.ref._dispatch(penv.numpy().copy())
    assert np.asarray(resp_r).tobytes() == resp_p.numpy().tobytes()
    words = resp_p[:16].view(torch.int32).tolist()
    assert words[1] == 2 and words[3] == 3


@pytest.mark.parametrize("route", [
    [jgateway.GW_MAGIC, 99, 1, 0],                  # unknown service id
    [jgateway.GW_MAGIC, 1, 77, 0],                  # client holds no key
    [0x12345678, 1, 1, 0],                          # not a gateway envelope
    [jgateway.GW_BATCH_MAGIC, 99, 1, 2],            # batch: unknown service
    [jgateway.GW_SCAT_MAGIC, 1, 0, 0],              # scatter of 0 items
    [jgateway.GW_SCAT_MAGIC, 1, 2, 0],              # truncated scatter
])
def test_whole_envelope_errors_bit_for_bit(pair, route):
    env = np.concatenate([np.asarray(route, "<u4").view(np.uint8),
                          np.zeros(512, np.uint8)])
    resp_r = pair.ref._dispatch(env.copy())
    resp_p = pair.port._dispatch(torch.from_numpy(env.copy()))
    assert np.asarray(resp_r).tobytes() == resp_p.numpy().tobytes()
    assert pair.ref.stats == pair.port.stats


def test_short_envelope_error_bit_for_bit(pair):
    env = np.asarray([1, 2, 3], np.uint8)
    assert (np.asarray(pair.ref._dispatch(env.copy())).tobytes()
            == pair.port._dispatch(torch.from_numpy(env.copy())).numpy().tobytes())


def test_foreign_channel_frame_refused_the_same_way(pair):
    """A frame sealed under the client's wc channel, routed to echo: both
    gateways refuse it with the same FrameError blob."""
    rc, pc = pair.clients["alice"]
    wc_r, wc_p = rc.open("wc"), pc.open("wc")
    echo_sid = rc.open("echo").sid
    pc.open("echo")
    renv = jgateway._seal_envelope(
        [jgateway.GW_MAGIC, echo_sid, rc.cid, 0], np.arange(3, dtype=np.int32),
        seed=wc_r.seed, seq=0, mac_impl=pair.ref._mac)
    penv = gateway._seal_envelope(
        [gateway.GW_MAGIC, echo_sid, pc.cid, 0], np.arange(3, dtype=np.int32),
        seed=wc_p.seed, seq=0, device="cpu")
    assert np.asarray(renv).tobytes() == penv.numpy().tobytes()
    resp_r = pair.ref._dispatch(penv.numpy().copy())
    resp_p = pair.port._dispatch(torch.from_numpy(np.asarray(renv).copy()))
    assert np.asarray(resp_r).tobytes() == resp_p.numpy().tobytes()
    assert b"FrameError" in resp_p.numpy().tobytes()
