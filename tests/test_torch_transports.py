"""The port's transport zoo against the reference's on the CPU: the cases of
``tests/test_transports.py`` run against ``repro_torch``'s six transports
(exact counts, shm's capacity, mpklink's sync scaling, sequenced
requests), each transport's round trip matching the reference
transport's count, the word-count workload itself, frames sealed in a
port session's region and in a reference session's region verifying
under the other package with the same derived seed, typed errors across
every wire, the ring path's key syncs, and the IPC sweep's launch and
sync arithmetic."""
import numpy as np
import pytest
import torch

from repro.core import TRANSPORTS as JTRANSPORTS
from repro.core import framing as jframing
from repro.core import wordcount as jwordcount
from repro.core.transports import MPKLinkTransport as JMPKLinkTransport

from repro_torch.core import TRANSPORTS, framing
from repro_torch.core.transports import (CapacityError, MPKLinkOptTransport,
                                         MPKLinkTransport, Overloaded,
                                         RateLimited, ShmTransport,
                                         TransportError)
from repro_torch.core.wordcount import (count_words, make_text, parse_count,
                                        wordcount_handler)
from repro_torch.launch import ipc_wordcount as ipc

NAMES = sorted(TRANSPORTS)


def _port(name, handler=wordcount_handler, **kw):
    return TRANSPORTS[name](handler, device="cpu", **kw)


def test_registry_names_match_the_reference():
    assert sorted(TRANSPORTS) == sorted(JTRANSPORTS)


@pytest.mark.parametrize("n", [1, 2, 100, 1000])
def test_make_text_exact_counts(n):
    text = make_text(n, seed=n)
    assert np.array_equal(text, jwordcount.make_text(n, seed=n))
    assert int(count_words(torch.from_numpy(text))[0]) == n
    assert int(jwordcount.count_words(text)[0]) == n


@pytest.mark.parametrize("text", [b"", b" ", b"a", b"  ab  c ", b"x y\tz"])
def test_count_words_matches_reference_on_edges(text):
    arr = np.frombuffer(text, np.uint8)
    want = int(jwordcount.count_words(arr)[0])
    assert int(count_words(torch.from_numpy(arr.copy()))[0]) == want
    resp = wordcount_handler(torch.from_numpy(arr.copy()))
    assert resp.dtype == torch.uint8 and resp.numel() == 8
    assert resp.numpy().tobytes() == jwordcount.wordcount_handler(arr).tobytes()
    assert parse_count(resp) == jwordcount.parse_count(
        jwordcount.wordcount_handler(arr)) == want


@pytest.mark.parametrize("name", NAMES)
def test_roundtrip(name):
    """1, 100, 1000 and 20,000 words (20,000 ≈ 140 KB: past grpc_sim's
    64 KiB window, so WINDOW_UPDATE frames flow) through the port's and the
    reference's transport: the same exact counts."""
    tr = _port(name)
    ref = JTRANSPORTS[name](jwordcount.wordcount_handler)
    tr.start()
    ref.start()
    try:
        for n in (1, 100, 1000, 20_000):
            if name == "shm" and n == 20_000:
                continue                          # within capacity, keep fast
            text = make_text(n, seed=n)
            got = parse_count(tr.request(text))
            want = jwordcount.parse_count(np.asarray(ref.request(text)))
            assert got == want == n, name
    finally:
        tr.close()
        ref.close()


def test_shm_capacity_failure():
    """Paper §VII: the raw shm baseline is incapable of ≥100k-word requests."""
    tr = ShmTransport(wordcount_handler, device="cpu")
    tr.start()
    try:
        assert parse_count(tr.request(make_text(10_000, seed=1))) == 10_000
        with pytest.raises(CapacityError):
            tr.request(make_text(100_000, seed=2))
    finally:
        tr.close()


def test_shm_capacity_refuses_an_oversized_response():
    tr = ShmTransport(lambda req: torch.zeros(600_000, dtype=torch.uint8),
                      device="cpu")
    tr.start()
    try:
        with pytest.raises(CapacityError, match="response"):
            tr.request(np.arange(4, dtype=np.uint8))
    finally:
        tr.close()


def test_mpklink_sync_scaling():
    """Key syncs grow with payload for the paper-faithful transport (the
    large-payload cliff §VII/§IX) and stay O(1) for the batched variant."""
    tr = MPKLinkTransport(wordcount_handler, device="cpu")
    tr.start()
    try:
        tr.request(make_text(100, seed=1))
        small = tr.sync_count
        big = make_text(200_000, seed=2)
        tr.request(big)
        large = tr.sync_count - small
    finally:
        tr.close()
    assert small <= 3
    assert large > 10 * small
    assert large == ipc.lockstep_syncs(tr, big.nbytes)

    opt = MPKLinkOptTransport(wordcount_handler, device="cpu")
    opt.start()
    try:
        opt.request(make_text(100, seed=1))
        s = opt.sync_count
        opt.request(make_text(200_000, seed=2))
        l = opt.sync_count - s
    finally:
        opt.close()
    assert l <= 3                                 # one data sync + one response


def test_mpklink_sync_counts_match_the_reference():
    for n in (10, 20_000, 100_000):
        text = make_text(n, seed=n)
        counts = []
        for tr in (MPKLinkTransport(wordcount_handler, device="cpu"),
                   JMPKLinkTransport(jwordcount.wordcount_handler)):
            tr.start()
            try:
                tr.request(text)
                counts.append(tr.sync_count)
            finally:
                tr.close()
        assert counts[0] == counts[1], n


def test_mpklink_multiple_sequenced_requests():
    tr = MPKLinkTransport(wordcount_handler, device="cpu")
    tr.start()
    try:
        for i, n in enumerate((10, 500, 50)):
            assert parse_count(tr.request(make_text(n, seed=i))) == n
        assert tr._seq == 3
    finally:
        tr.close()


def test_mpklink_request_into_seals_in_the_region():
    tr = MPKLinkOptTransport(wordcount_handler, device="cpu")
    s = tr.connect("producer")
    text = make_text(700, seed=4)
    try:
        def fill(dst):
            assert dst.dtype == torch.uint8 and dst.numel() == text.nbytes
            dst.copy_(torch.from_numpy(text))

        assert parse_count(s.request_into(text.nbytes, fill)) == 700
        rows = framing.frame_rows(text.nbytes)
        want = framing.build_frame(text, seed=s.seed, seq=0, device="cpu")
        assert torch.equal(s._region_req[:rows].view(torch.int32),
                           want.view(torch.int32))
    finally:
        tr.close()


def test_default_sessions_derive_the_references_seed():
    """Same registry seed, same names: the port's and the reference's
    default mpklink sessions derive the same domain tag, keys' PKRU word
    and session MAC seed."""
    ours = MPKLinkTransport(wordcount_handler, device="cpu")
    theirs = JMPKLinkTransport(jwordcount.wordcount_handler)
    try:
        assert ours.seed == theirs.seed
        assert ours.domain.tag == theirs.domain.tag
        assert (ours.registry.pkru_word((ours.key_client,))
                == theirs.registry.pkru_word((theirs.key_client,)))
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("n", [5, 3000])
def test_frames_cross_parse_both_ways(n):
    """A request and a response frame sealed in a port mpklink session's
    regions verify under ``repro.core.framing.verify_view`` with the same
    derived seed, and the reference's under the port's; the regions hold
    the same words."""
    text = make_text(n, seed=9)
    ours = MPKLinkTransport(wordcount_handler, device="cpu")
    theirs = JMPKLinkTransport(jwordcount.wordcount_handler)
    ours.start()
    theirs.start()
    try:
        assert parse_count(ours.request(text)) == n
        assert jwordcount.parse_count(np.asarray(theirs.request(text))) == n
        so, st = ours._default, theirs._default
        assert so.seed == st.seed
        req_rows = framing.frame_rows(text.nbytes)
        resp_rows = framing.frame_rows(8)
        port_req = so._region_req[:req_rows].numpy()
        port_resp = so._region_resp[:resp_rows].numpy()
        ref_req = np.array(st._region_req[:req_rows])
        ref_resp = np.array(st._region_resp[:resp_rows])
        assert np.array_equal(port_req, ref_req)
        assert np.array_equal(port_resp, ref_resp)
        got = jframing.verify_view(port_req, seed=so.seed, expect_seq=0)
        assert np.array_equal(np.asarray(got), text)
        got = jframing.verify_view(port_resp, seed=so.seed, expect_seq=0)
        assert jwordcount.parse_count(np.asarray(got)) == n
        back = framing.verify_view(torch.from_numpy(ref_req), seed=st.seed,
                                   expect_seq=0)
        assert np.array_equal(back.numpy(), text)
        back = framing.verify_view(torch.from_numpy(ref_resp), seed=st.seed,
                                   expect_seq=0)
        assert parse_count(back) == n
        bad = ref_req.copy()
        bad[1, 7] ^= np.uint32(1 << 3)
        with pytest.raises(framing.FrameError, match="MAC"):
            framing.verify_view(torch.from_numpy(bad), seed=st.seed,
                                expect_seq=0)
    finally:
        ours.close()
        theirs.close()


def test_ring_frames_cross_parse():
    """Frames a port session stages into its ring (``call_batch``'s
    ``seal_into_batch``) verify under the reference's ``verify_batch``."""
    captured = []

    def handler(req):
        captured.append(req.clone())
        return wordcount_handler(req)

    tr = MPKLinkOptTransport(handler, device="cpu")
    s = tr.connect("ring")
    texts = [make_text(40 + i, seed=i) for i in range(5)]
    try:
        ring = s._ring_obj()
        frames = []
        orig = s._stage_frame

        def spy(frame, buf=None):
            frames.append(frame.clone().numpy())
            return orig(frame, buf=buf)

        s._stage_frame = spy
        outs = s.call_batch(texts)
        assert [parse_count(o) for o in outs] == [40 + i for i in range(5)]
        got = jframing.verify_batch(frames, seed=s.seed, start_seq=0)
        for g, t in zip(got, texts):
            assert np.array_equal(np.asarray(g), t)
        assert ring.capacity == tr.ring_slots
    finally:
        tr.close()
    assert [c.numpy().tobytes() for c in captured] == [t.tobytes() for t in texts]


def test_frames_of_one_session_fail_on_another():
    tr = MPKLinkOptTransport(wordcount_handler, device="cpu")
    a, b = tr.connect("a"), tr.connect("b")
    try:
        assert a.seed != b.seed
        parse_count(a.request(make_text(20, seed=0)))
        rows = framing.frame_rows(make_text(20, seed=0).nbytes)
        with pytest.raises(framing.FrameError, match="seed"):
            framing.verify_view(a._region_req[:rows], seed=b.seed)
    finally:
        tr.close()


@pytest.mark.parametrize("name", NAMES)
def test_typed_errors_cross_every_wire(name):
    """A handler's typed error reaches the client typed, with its
    ``retry_after`` hint across the stream wires (a float in the
    MessagePack error body), and the session keeps serving."""
    def handler(req):
        if int(req.reshape(-1)[0]) == 1:
            raise RateLimited("slow down", retry_after=0.25)
        if int(req.reshape(-1)[0]) == 2:
            raise Overloaded("busy", retry_after=1.5)
        return wordcount_handler(req)

    tr = _port(name, handler)
    s = tr.connect("errs")
    try:
        with pytest.raises(RateLimited) as e:
            s.request(np.asarray([1, 0], np.uint8))
        assert e.value.retry_after == 0.25
        with pytest.raises(Overloaded) as e:
            s.request(np.asarray([2, 0], np.uint8))
        assert e.value.retry_after == 1.5
        assert parse_count(s.request(make_text(30, seed=1))) == 30
    finally:
        tr.close()


@pytest.mark.parametrize("name", ["shm", "mpklink", "mpklink_opt"])
def test_ring_batches_count_exactly(name):
    tr = _port(name)
    s = tr.connect("batch")
    texts = [make_text(100 + 37 * i, seed=i) for i in range(8)]
    try:
        outs = s.call_batch(texts)
        assert [parse_count(o) for o in outs] == [100 + 37 * i for i in range(8)]
        assert all(o.device.type == "cpu" and o.dtype == torch.uint8 for o in outs)
    finally:
        tr.close()


@pytest.mark.parametrize("name,per_batch", [("mpklink_opt", 2), ("mpklink", None)])
def test_ring_key_syncs_per_batch(name, per_batch):
    """A ``call_batch`` through an mpklink ring costs one flush sync
    (chunk-scaled for mpklink) and one response-side sync for the drain
    pass, whatever the number of messages."""
    tr = _port(name, ring_slots=8)
    s = tr.connect("syncs")
    texts = [make_text(3000 + i, seed=i) for i in range(8)]
    try:
        s.call_batch(texts[:1])
        before = s.sync_count
        s.call_batch(texts)
        got = s.sync_count - before
    finally:
        tr.close()
    staged = sum(framing.frame_rows(t.nbytes) for t in texts) * 512
    want = per_batch if per_batch else -(-staged // tr.chunk) + 1
    assert got == want


def test_ipc_launch_arithmetic():
    """The counts the card run holds its launches to, from the code's
    structure: a lockstep mpklink request is two streaming seals (one
    ``mac_update`` per 65,536 payload rows) and two ``guard_copy``; a ring
    window is four ``mac_batch`` passes, one launch per row count each."""
    small = make_text(100, seed=1).nbytes
    assert ipc.lockstep_launches("mpklink_opt", small, "cuda") == {
        "mac_init_state": 2, "mac_update": 2, "mac_finalize": 2, "guard_copy": 2}
    assert ipc.lockstep_launches("mpklink", 65536 * 512 + 1, "cuda")["mac_update"] == 3
    assert ipc.lockstep_launches("uds", small, "cuda") == {}
    assert ipc.lockstep_launches("mpklink", small, "cpu") == {}
    assert ipc.ring_launches([100, 100, 600], "cuda") == {"mac_batch": 2 * 2 + 2 * 1}
    assert ipc.ring_launches([100], "cpu") == {}


def test_ipc_sweep_and_claims_on_the_cpu():
    """The sweep's records are exact (counts, syncs, launches; checked in
    ``measure``), shm refuses 1e5 words, and the functional claims hold."""
    recs = []
    results = ipc.sweep([100, 1000, 100_000], reps=1, device="cpu",
                        emit=recs.append)
    assert results["shm"][100_000] is None
    assert all(results[n][100] is not None for n in ipc.ORDER)
    opt = [r for r in recs if r["transport"] == "mpklink_opt"]
    assert [r["key_syncs_per_request"] for r in opt] == [2, 2, 2]
    mpk = [r for r in recs if r["transport"] == "mpklink"]
    assert mpk[-1]["key_syncs_per_request"] == ipc.lockstep_syncs(
        MPKLinkTransport(wordcount_handler, device="cpu"), mpk[-1]["bytes"])
    rows = ipc.table_rows(results)
    assert ("fig2", "shm", 100_000, None) in rows
    assert any(r[0] == "table1" for r in rows)


def test_region_checks_on_the_cpu():
    got = ipc.region_checks("cpu", n_words=500)
    assert got["count"] == 500 and got["tampered_refused"]


def test_concurrent_sessions_on_the_cpu():
    got = ipc.concurrent_sessions(n_sessions=4, batch=4, n_words=200,
                                  rounds=2, device="cpu")
    assert got["requests"] == 32
    assert got["key_syncs_per_request"] == 0.5        # 2 a batch of 4


def test_cuda_transport_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MPKLinkOptTransport(wordcount_handler)


def test_closed_session_refuses():
    tr = _port("mpklink_opt")
    s = tr.connect("closing")
    s.close()
    with pytest.raises(TransportError, match="closed"):
        s.request(make_text(3, seed=0))
    tr.close()
