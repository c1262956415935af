"""The reference's adversarial cases (``tests/test_adversarial.py``) run
against the port's gateway on the CPU, under their own names: old-epoch
replays, cross-service seed reuse, stolen keys of revoked identities,
open/close spam, token replays that would rewind a channel, and
client-scoped idempotency tokens."""
import numpy as np
import pytest
import torch

from repro_torch.core import ServiceGateway as _ServiceGateway, framing
from repro_torch.core import signature as sig
from repro_torch.core.ca import enroll
from repro_torch.core.domains import RW, AccessViolation
from repro_torch.core.gateway import GW_MAGIC, _ROUTE_BYTES, _route
from repro_torch.core.transports import _raise_remote
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



def _reverse(req):
    return np.ascontiguousarray(np.asarray(req)[::-1])


def _gateway(transport="mpklink_opt", **kw):
    gw = ServiceGateway(transport, **kw)
    gw.register_service("wordcount", wordcount_handler)
    gw.register_service("reverse", _reverse)
    return gw.start()


def assert_invariants(gw):
    """Registry/CA invariants that must survive every attack:
    live channel keys are issued + epoch-current, service keys pass their
    own PKRU check, the domain table is within the hardware budget, and
    certificate records verify."""
    reg = gw.registry
    for (cid, sid), ch in list(gw._channels.items()):
        dom = ch.client_key.domain
        assert dom.did in reg._domains, "channel on a freed domain"
        if ch.client_key.epoch == reg.epoch(dom):
            assert ch.client_key.nonce in reg._issued[dom.did], \
                "epoch-current channel holds an unissued/revoked key"
        else:
            # lazily re-keyed channel: MUST fail the PKRU check loudly the
            # moment it is used — stale keys never pass silently
            with pytest.raises(AccessViolation):
                reg.check(ch.client_key, RW)
    for svc in gw._services.values():
        reg.check(svc.server_key, RW)          # raises on any corruption
        assert svc.server_key.epoch == reg.epoch(svc.domain)
    assert len(reg._domains) <= reg._max
    for rec in gw.ca._services.values():
        if rec.verified:
            assert gw.ca.verify_cert(rec), f"corrupt cert for {rec.name}"


def _send_raw(client, sid, cid, frame):
    env = np.concatenate([_route(sid, cid, 0),
                          frame.reshape(-1).view(np.uint8)])
    resp = np.ascontiguousarray(np.asarray(client._session.request(env))) \
        .view(np.uint8).reshape(-1)
    route = resp[:_ROUTE_BYTES].view("<u4")
    assert int(route[0]) == GW_MAGIC
    return int(route[1]), resp[_ROUTE_BYTES:]


def _expect_reject(client, sid, cid, frame, exc_types):
    status, body = _send_raw(client, sid, cid, frame)
    assert status == 1, "gateway ACCEPTED an attack envelope"
    with pytest.raises(exc_types):
        _raise_remote(body[: 512].tobytes())


# ---------------------------------------------------------------------------
# 1. replayed frames under an old epoch
# ---------------------------------------------------------------------------

def test_old_epoch_replay_rejected():
    gw = _gateway()
    try:
        alice, bob = gw.connect("alice"), gw.connect("bob")
        assert parse_count(alice.call("wordcount", make_text(7, seed=0))) == 7
        assert parse_count(bob.call("wordcount", make_text(8, seed=0))) == 8
        a_chan = alice._channels["wordcount"]
        b_chan = bob._channels["wordcount"]
        # capture a frame exactly as alice would send her NEXT request,
        # and bob's stale-seed image, BEFORE the epoch bump
        a_replay = _build_frame(make_text(7, seed=0),
                                       seed=a_chan.seed, seq=a_chan.seq)
        b_stale = _build_frame(make_text(8, seed=0),
                                      seed=b_chan.seed, seq=b_chan.seq)
        gw.revoke(alice, "wordcount")          # epoch bump on the domain

        # alice's captured frame: her channel is gone → no key for cid
        _expect_reject(alice, a_chan.sid, alice.cid, a_replay,
                       AccessViolation)
        # bob still holds a channel object, but its key is one epoch old:
        # the PKRU staging check rejects before the handler ever runs
        _expect_reject(bob, b_chan.sid, bob.cid, b_stale, AccessViolation)
        assert_invariants(gw)

        # zero corruption: bob transparently re-keys and keeps working
        assert parse_count(bob.call("wordcount", make_text(9, seed=1))) == 9
        # ...and an in-sequence replay of bob's OWN earlier frame under the
        # NEW epoch still fails (sequence window moved on)
        nb = bob._channels["wordcount"]
        replay2 = _build_frame(make_text(9, seed=1), seed=nb.seed,
                                      seq=nb.seq - 1)
        _expect_reject(bob, nb.sid, bob.cid, replay2, framing.FrameError)
        assert_invariants(gw)
        assert parse_count(bob.call("wordcount", make_text(5, seed=2))) == 5
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# 2. cross-service seed reuse
# ---------------------------------------------------------------------------

def test_cross_service_seed_reuse_rejected():
    gw = _gateway()
    try:
        eve = gw.connect("eve")
        chan_wc = eve.open("wordcount")
        chan_rv = eve.open("reverse")
        payload = np.arange(16, dtype=np.int32)

        # a frame MAC-seeded for wordcount, addressed to reverse (and vice
        # versa): the per-service domain seed must reject it at the guard
        f_wc = _build_frame(payload, seed=chan_wc.seed,
                                   seq=chan_rv.seq)
        _expect_reject(eve, chan_rv.sid, eve.cid, f_wc, framing.FrameError)
        f_rv = _build_frame(payload, seed=chan_rv.seed,
                                   seq=chan_wc.seq)
        _expect_reject(eve, chan_wc.sid, eve.cid, f_rv, framing.FrameError)
        assert_invariants(gw)

        # neither service's sequence window moved: in-order calls still work
        np.testing.assert_array_equal(
            np.asarray(eve.call("reverse", payload)), payload[::-1])
        assert parse_count(eve.call("wordcount", make_text(6, seed=3))) == 6
        assert gw.stats["rejected"] >= 2
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# 3. revoked client re-registering under a new name with a stolen key
# ---------------------------------------------------------------------------

def test_revoked_identity_cannot_alias_with_stolen_key():
    gw = _gateway()
    try:
        mallory = gw.connect("mallory")
        assert parse_count(mallory.call("wordcount", make_text(4, seed=0))) == 4
        gw.ca.revoke_service("mallory")

        # same name: refused (ban survives reconnects)
        with pytest.raises(AccessViolation, match="revoked"):
            gw.connect("mallory")

        # new name, STOLEN key: mallory's key pair signs a registration for
        # "totally-new-client" — the CA must refuse the alias, revoked keys
        # don't get fresh identities
        stolen = sig.KeyPair.generate("mallory")
        proof = sig.sign(stolen.private,
                         f"register:totally-new-client:{stolen.public}".encode())
        with pytest.raises(AccessViolation, match="bound to identity"):
            gw.ca.register("totally-new-client", stolen.public, proof)
        # and the enroll() convenience path for an honest new client still
        # works (fresh key pair → fresh identity)
        enroll(gw.ca, "honest-newcomer")
        assert_invariants(gw)

        # mallory's existing channel is dead too: her next call re-keys via
        # the CA, which refuses the revoked certificate
        gw.revoke(mallory, "wordcount")
        with pytest.raises(AccessViolation):
            mallory.call("wordcount", make_text(4, seed=1))
        assert_invariants(gw)
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# 4. open/close spam: channel/key exhaustion
# ---------------------------------------------------------------------------

def test_open_close_spam_cannot_exhaust_channels():
    gw = _gateway(max_keys=24)
    reg = gw.registry
    try:
        legit = gw.connect("legit")
        assert parse_count(legit.call("wordcount", make_text(5, seed=0))) == 5
        domains_before = len(reg._domains)

        # (a) channel-level spam: re-keying the same service 100× must not
        # grow the issued-key table (replaced grants are retired)
        spammer = gw.connect("spammer")
        spammer.open("wordcount")
        svc_dom = gw._services["wordcount"].domain
        issued_before = len(reg._issued[svc_dom.did])
        for _ in range(100):
            spammer.reopen("wordcount")
        assert len(reg._issued[svc_dom.did]) == issued_before
        assert parse_count(spammer.call("wordcount", make_text(6, seed=1))) == 6
        spammer.close()

        # (b) client-level spam: connect/close 50× on a 24-key table —
        # freed link domains must be recycled like pkey_free/pkey_alloc
        for i in range(50):
            c = gw.connect(f"churn-{i}")
            c.open("wordcount")
            assert parse_count(c.call("wordcount", make_text(3, seed=i))) == 3
            c.close()
            assert len(reg._domains) <= reg._max
        assert len(reg._domains) == domains_before + 0 \
            or len(reg._domains) <= domains_before + 1
        assert_invariants(gw)

        # the table still has room for an honest newcomer afterwards
        fresh = gw.connect("fresh-after-spam")
        assert parse_count(fresh.call("wordcount", make_text(11, seed=2))) == 11
        assert_invariants(gw)
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# 5. dedup window cannot be used to double-execute or cross wires
# ---------------------------------------------------------------------------

def test_token_replay_cannot_rewind_the_sequence_window():
    """Replaying a captured envelope WITH its original idempotency token is
    answered from the dedup window (the attacker learns nothing the client
    didn't already receive) but must NOT rewind server_seq — subsequent
    in-order traffic keeps flowing (no one-packet replay DoS)."""
    gw = _gateway()
    try:
        victim = gw.connect("victim")
        chan = victim.open("wordcount")
        # capture request 0's exact envelope (seq 0, token 1) off the wire
        token = 1
        frame0 = _build_frame(make_text(7, seed=0), seed=chan.seed,
                                     seq=0)
        env0 = np.concatenate([_route(chan.sid, victim.cid, token),
                               frame0.reshape(-1).view(np.uint8)])
        for i in range(4):              # requests 0..3 complete normally
            assert parse_count(victim.call("wordcount",
                                           make_text(7, seed=0))) == 7
        assert gw._channels[(victim.cid, chan.sid)].server_seq == 4

        # replay the captured envelope: dedup answers it...
        resp = np.ascontiguousarray(
            np.asarray(victim._session.request(env0))) \
            .view(np.uint8).reshape(-1)
        assert int(resp[:_ROUTE_BYTES].view("<u4")[1]) == 0   # served
        assert gw.stats["deduped"] == 1
        # ...but the window did NOT rewind, and legit traffic continues
        assert gw._channels[(victim.cid, chan.sid)].server_seq == 4
        assert parse_count(victim.call("wordcount", make_text(5, seed=1))) == 5
        assert_invariants(gw)
    finally:
        gw.close()


def test_idempotency_tokens_are_client_scoped():
    """A token only dedups within (client id, token): two clients using the
    same token value never see each other's cached responses."""
    gw = _gateway()
    try:
        a, b = gw.connect("a"), gw.connect("b")
        ra = parse_count(a.call("wordcount", make_text(10, seed=0)))
        rb = parse_count(b.call("wordcount", make_text(20, seed=0)))
        assert (ra, rb) == (10, 20)
        svc = gw._services["wordcount"]
        assert {a.cid, b.cid} <= set(svc.done)  # one bucket per client id
        # both clients used token 1 for their first call — the buckets keep
        # them apart, and each client only ever sees its own cached answer
        assert 1 in svc.done[a.cid] and 1 in svc.done[b.cid]
        assert parse_count(svc.done[a.cid][1]) == 10
        assert parse_count(svc.done[b.cid][1]) == 20
        # one client's flood can never evict another client's pending token
        from repro_torch.core import gateway as gwmod
        for i in range(gwmod._DONE_TOKENS * 3):
            b.call("wordcount", make_text(2, seed=i))
        assert 1 in svc.done[a.cid]            # a's window untouched
        assert len(svc.done[b.cid]) == gwmod._DONE_TOKENS
        assert_invariants(gw)
    finally:
        gw.close()
