"""The doorbell/credit data plane and the in-place framing of the port, on
the CPU: the cases of ``tests/test_doorbell.py`` (hybrid spin/park
wakeups, wakeups per pass not per message, credit-based ring flow control,
per-poll timeouts, exact ``framing.STATS`` under concurrent writers) and
of ``tests/test_zero_copy.py``'s framing and ring sections against the
port's classes. Where the reference relies on numpy's aliasing (read-only
views, slots recycled once no view is alive), the port's rule is tested
instead: a slot is reused only after it is released, a released slot is
released once, and a payload handed back never changes when its slot is
reused."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import framing as jframing

from repro_torch.core import TRANSPORTS, framing
from repro_torch.core.transports import (CapacityError, Doorbell,
                                         MPKLinkOptTransport, ResponseTimeout,
                                         ShmTransport)
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler

SEED = 0x5EED1234


def _cpu(cls, handler=wordcount_handler, **kw):
    return cls(handler, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Doorbell primitive
# ---------------------------------------------------------------------------

def test_doorbell_ring_wakes_parked_waiter_and_counts():
    bell = Doorbell(threading.RLock(), spin=0)
    state = {"flag": False}
    woke = threading.Event()

    def waiter():
        assert bell.wait(lambda: state["flag"], timeout=10.0)
        woke.set()

    st0 = framing.STATS.snapshot()
    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.05)                    # let it park
    with bell.cond:
        state["flag"] = True
    bell.ring()
    assert woke.wait(5.0), "parked waiter never woke on ring()"
    t.join(5.0)
    assert not t.is_alive()
    st1 = framing.STATS.snapshot()
    assert st1["wakeups"] - st0["wakeups"] == 1
    assert st1["doorbell_parks"] - st0["doorbell_parks"] >= 1


def test_doorbell_true_predicate_never_parks():
    bell = Doorbell(threading.RLock())
    st0 = framing.STATS.snapshot()
    assert bell.wait(lambda: True, timeout=0.0)
    assert framing.STATS.snapshot()["doorbell_parks"] == st0["doorbell_parks"]


def test_doorbell_wait_times_out_false():
    bell = Doorbell(threading.RLock(), spin=0)
    t0 = time.perf_counter()
    assert not bell.wait(lambda: False, timeout=0.05)
    assert time.perf_counter() - t0 < 2.0


# ---------------------------------------------------------------------------
# wakeups scale with round trips, not messages
# ---------------------------------------------------------------------------

def test_batch_wakeups_are_per_pass_not_per_message():
    """16 lockstep exchanges ring ~3 bells each; one 16-message call_batch
    rings a small constant for the whole cohort."""
    tr = _cpu(MPKLinkOptTransport, ring_slots=16)
    lock = tr.connect("lockstep")
    lock.request(make_text(3, seed=0))          # warm the session
    st0 = framing.STATS.snapshot()
    for i in range(16):
        lock.request(make_text(i + 1, seed=i))
    lockstep_wakeups = framing.STATS.snapshot()["wakeups"] - st0["wakeups"]

    batch = tr.connect("batched")
    batch.request(make_text(3, seed=0))
    st0 = framing.STATS.snapshot()
    outs = batch.call_batch([make_text(i + 1, seed=i) for i in range(16)])
    batch_wakeups = framing.STATS.snapshot()["wakeups"] - st0["wakeups"]
    tr.close()
    assert [parse_count(o) for o in outs] == list(range(1, 17))
    assert lockstep_wakeups >= 3 * 16
    assert batch_wakeups <= 8, \
        f"a 16-message batch rang {batch_wakeups} bells (want one per pass)"
    assert lockstep_wakeups >= 4 * batch_wakeups


def test_key_syncs_mirrored_into_frame_stats():
    tr = _cpu(MPKLinkOptTransport)
    s = tr.connect("sync-stats")
    s.request(make_text(3, seed=0))
    st0 = framing.STATS.snapshot()
    base = tr.sync_count
    for i in range(4):
        s.request(make_text(i + 1, seed=i))
    delta_local = tr.sync_count - base
    delta_stats = framing.STATS.snapshot()["key_syncs"] - st0["key_syncs"]
    tr.close()
    assert delta_local == delta_stats == 8      # 2 per lockstep exchange


# ---------------------------------------------------------------------------
# credit-based flow control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [ShmTransport, MPKLinkOptTransport])
def test_full_ring_backpressures_with_concurrent_poller(cls):
    """A producer thread pushes 4x the ring depth while a consumer polls:
    submit() must block for credits and never raise CapacityError."""
    tr = _cpu(cls, ring_slots=4, credit_wait=10.0)
    s = tr.connect("pc")
    total = 16
    tickets: list = []
    errs: list = []
    got: list = []
    tcv = threading.Condition()

    def producer():
        try:
            for i in range(total):
                t = s.submit(make_text(i + 1, seed=i))
                with tcv:
                    tickets.append(t)
                    tcv.notify_all()
                s.flush()
        except Exception as e:
            errs.append(e)
            with tcv:
                tcv.notify_all()

    def consumer():
        try:
            for i in range(total):
                with tcv:
                    while len(tickets) <= i and not errs:
                        tcv.wait(5.0)
                    if errs:
                        return
                    t = tickets[i]
                got.append(parse_count(s.poll(t, timeout=10.0)))
        except Exception as e:
            errs.append(e)

    tp = threading.Thread(target=producer, daemon=True)
    tc = threading.Thread(target=consumer, daemon=True)
    tp.start()
    tc.start()
    tp.join(30.0)
    tc.join(30.0)
    tr.close()
    assert not tp.is_alive() and not tc.is_alive()
    assert not errs, errs
    assert got == list(range(1, total + 1))


def test_full_ring_without_poller_raises_typed_after_bounded_wait():
    tr = _cpu(ShmTransport, ring_slots=2, credit_wait=0.1)
    s = tr.connect("serial-overflow")
    try:
        t0 = s.submit(make_text(1, seed=0))
        t1 = s.submit(make_text(2, seed=0))
        start = time.perf_counter()
        with pytest.raises(CapacityError, match="ring full"):
            s.submit(make_text(3, seed=0))
        elapsed = time.perf_counter() - start
        assert 0.05 <= elapsed < 5.0, \
            f"credit wait not bounded by credit_wait: {elapsed}s"
        # the credit wait published the staged slots — they still redeem
        assert parse_count(s.poll(t0)) == 1
        assert parse_count(s.poll(t1)) == 2
    finally:
        tr.close()


@pytest.mark.parametrize("cls", [ShmTransport, MPKLinkOptTransport])
def test_submit_timeout_clamps_credit_wait_to_caller_budget(cls):
    """``submit(timeout=...)`` against a full ring clamps the credit wait to
    the caller's budget (ResponseTimeout, the session not poisoned); a
    tighter credit window still raises CapacityError."""
    tr = _cpu(cls, ring_slots=2, credit_wait=30.0)
    s = tr.connect("clamped-overflow")
    try:
        t0 = s.submit(make_text(1, seed=0))
        t1 = s.submit(make_text(2, seed=0))
        start = time.perf_counter()
        with pytest.raises(ResponseTimeout, match="call budget"):
            s.submit(make_text(3, seed=0), timeout=0.05)
        assert time.perf_counter() - start < 5.0, \
            "caller budget did not clamp the 30s credit_wait"
        assert parse_count(s.poll(t0)) == 1
        assert parse_count(s.poll(t1)) == 2
    finally:
        tr.close()
    tr2 = _cpu(cls, ring_slots=2, credit_wait=0.08)
    s2 = tr2.connect("credit-overflow")
    try:
        u0 = s2.submit(make_text(1, seed=1))
        u1 = s2.submit(make_text(2, seed=1))
        with pytest.raises(CapacityError, match="ring full"):
            s2.submit(make_text(3, seed=1), timeout=30.0)
        assert parse_count(s2.poll(u0)) == 1
        assert parse_count(s2.poll(u1)) == 2
    finally:
        tr2.close()


# ---------------------------------------------------------------------------
# per-poll / per-request timeouts
# ---------------------------------------------------------------------------

def _slow_handler(req):
    time.sleep(1.0)
    return req


@pytest.mark.parametrize("cls", [MPKLinkOptTransport, ShmTransport])
def test_ring_poll_honors_tighter_timeout(cls):
    """Transport deadline 30 s; poll(timeout=0.15) must expire in well under
    a second, through the doorbell wait."""
    tr = _cpu(cls, _slow_handler, timeout=30.0)
    s = tr.connect("tight")
    try:
        t = s.submit(np.arange(8, dtype=np.uint8))
        s.flush()
        t0 = time.perf_counter()
        with pytest.raises(ResponseTimeout):
            s.poll(t, timeout=0.15)
        assert time.perf_counter() - t0 < 5.0
        assert s._poisoned                  # same poisoning as a full expiry
    finally:
        tr.close()


@pytest.mark.parametrize("name", ["pipe", "uds", "grpc_sim"])
def test_lockstep_fallback_poll_honors_tighter_timeout(name):
    tr = TRANSPORTS[name](_slow_handler, timeout=30.0, device="cpu")
    s = tr.connect("tight-fallback")
    try:
        t = s.submit(np.arange(8, dtype=np.uint8))
        s.flush()
        t0 = time.perf_counter()
        with pytest.raises(ResponseTimeout):
            s.poll(t, timeout=0.15)
        assert time.perf_counter() - t0 < 5.0
    finally:
        tr.close()


def test_request_timeout_param_overrides_transport_deadline():
    tr = _cpu(ShmTransport, _slow_handler, timeout=30.0)
    s = tr.connect("req-tight")
    try:
        t0 = time.perf_counter()
        with pytest.raises(ResponseTimeout):
            s.request(np.arange(8, dtype=np.uint8), timeout=0.15)
        assert time.perf_counter() - t0 < 5.0
    finally:
        tr.close()


def test_poll_default_timeout_still_transport_deadline():
    tr = _cpu(MPKLinkOptTransport, lambda req: (time.sleep(0.3), req)[1],
              timeout=10.0)
    s = tr.connect("default-deadline")
    try:
        t = s.submit(np.arange(8, dtype=np.uint8))
        s.flush()
        out = s.poll(t)                     # 0.3 s handler < 10 s deadline
        assert out.tolist() == list(range(8))
    finally:
        tr.close()


# ---------------------------------------------------------------------------
# FrameStats: exact under concurrency
# ---------------------------------------------------------------------------

def test_frame_stats_bump_is_exact_under_threads():
    st0 = framing.STATS.snapshot()
    n_threads, per_thread = 8, 2000

    def bumper():
        for _ in range(per_thread):
            framing.STATS.bump(wakeups=1, bytes_copied=3)

    ts = [threading.Thread(target=bumper) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    st1 = framing.STATS.snapshot()
    assert st1["wakeups"] - st0["wakeups"] == n_threads * per_thread
    assert st1["bytes_copied"] - st0["bytes_copied"] == 3 * n_threads * per_thread


def test_frame_stats_exact_for_concurrent_sealers():
    """N threads sealing M frames each through the real seal path: the
    sharded counters drop no increment."""
    st0 = framing.STATS.snapshot()
    n_threads, per_thread = 4, 40
    payload = np.arange(256, dtype=np.uint8)

    def sealer(i):
        buf = torch.empty((framing.frame_rows(payload.nbytes), framing.LANES),
                          dtype=torch.uint32)
        for j in range(per_thread):
            framing.seal_into(buf, payload, seed=i, seq=j)

    ts = [threading.Thread(target=sealer, args=(i,)) for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    st1 = framing.STATS.snapshot()
    total = n_threads * per_thread
    assert st1["frames_sealed"] - st0["frames_sealed"] == total
    assert st1["frames_sealed_inplace"] - st0["frames_sealed_inplace"] == total
    assert st1["bytes_copied"] - st0["bytes_copied"] == total * payload.nbytes


def test_frame_stats_unknown_field_raises():
    with pytest.raises(KeyError):
        framing.STATS.bump(no_such_counter=1)


def test_frame_stats_attribute_reads_sum_shards():
    framing.STATS.bump(concat_calls=2)
    snap = framing.STATS.snapshot()
    assert framing.STATS.concat_calls == snap["concat_calls"]


def test_frame_stats_prunes_dead_thread_shards():
    st0 = framing.STATS.snapshot()

    def bump_once():
        framing.STATS.bump(wakeups=1)

    for _ in range(30):
        t = threading.Thread(target=bump_once)
        t.start()
        t.join(10)
    st1 = framing.STATS.snapshot()      # snapshot folds the dead shards
    assert st1["wakeups"] - st0["wakeups"] == 30
    with framing.STATS._rlock:
        dead = sum(1 for th, _ in framing.STATS._shards if not th.is_alive())
    assert dead == 0, f"{dead} dead shards survived the fold"


# ---------------------------------------------------------------------------
# in-place framing (tests/test_zero_copy.py's framing section)
# ---------------------------------------------------------------------------

def _sample(dtype, shape):
    n = int(np.prod(shape, dtype=np.int64))
    base = np.arange(max(n, 1), dtype=np.int64) % 251
    return base[:n].astype(dtype).reshape(shape)


@pytest.mark.parametrize("code", sorted(jframing._DTYPES))
def test_seal_into_bit_identical_every_dtype(code):
    """Into a dirty oversized buffer, every dtype and shape: the port's
    in-place seal equals the reference's frame word for word and
    verifies, and the payload comes back from the guard's copy."""
    dtype = jframing._DTYPES[code]
    for shape in [(0,), (1,), (13,), (128,), (3, 4), (2, 3, 4), (513,)]:
        arr = _sample(dtype, shape)
        rows = framing.frame_rows(arr.nbytes)
        buf = torch.full((rows + 3, framing.LANES), -0x21524111,
                         dtype=torch.int32).view(torch.uint32)  # 0xDEADBEEF
        used = framing.seal_into(buf, arr, seed=SEED, seq=7)
        assert used == rows
        want = jframing.build_frame(arr, seed=SEED, seq=7)
        assert np.array_equal(buf[:rows].numpy(), want)
        assert np.array_equal(buf[rows:].view(torch.int32).numpy(),
                              np.full((3, framing.LANES), -0x21524111, np.int32))
        out = framing.verify_view(buf[:rows], seed=SEED, expect_seq=7)
        assert np.array_equal(out.numpy(), arr)
        if arr.nbytes:                  # the guarded copy, not the buffer
            assert out.untyped_storage().data_ptr() != \
                buf.untyped_storage().data_ptr()


def test_seal_into_batch_matches_seal_batch():
    arrays = [_sample(np.uint8, (n,)) for n in (1, 511, 512, 4096)] \
        + [_sample(np.int32, (3, 4)), np.zeros(0, np.uint8)]
    seqs = [3, 9, 12, 40, 41, 42]
    want = jframing.seal_batch(arrays, seed=SEED, seqs=seqs)
    ours = framing.seal_batch(arrays, seed=SEED, seqs=seqs, device="cpu")
    bufs = [torch.full((framing.frame_rows(a.nbytes), framing.LANES), 0x25A5A5A5,
                       dtype=torch.int32).view(torch.uint32) for a in arrays]
    rows = framing.seal_into_batch(bufs, arrays, seed=SEED, seqs=seqs)
    for b, r, w, o in zip(bufs, rows, want, ours):
        assert np.array_equal(b[:r].numpy(), w)
        assert np.array_equal(o.numpy(), w)
    # per-frame seals agree with the batched MAC pass
    for b, a, q in zip(bufs, arrays, seqs):
        single = framing.build_frame(a, seed=SEED, seq=q, device="cpu")
        assert torch.equal(single.view(torch.int32),
                           b[:single.shape[0]].view(torch.int32))


def test_seal_prefilled_equals_seal_into():
    body = _sample(np.uint8, (1000,))
    rows = framing.frame_rows(body.nbytes)
    buf = torch.full((rows, framing.LANES), 7, dtype=torch.int32).view(torch.uint32)
    buf[1:].reshape(-1).view(torch.uint8)[:1000] = torch.from_numpy(body)
    assert framing.seal_prefilled(buf, 1000, seed=SEED, seq=4) == rows
    want = jframing.build_frame(body, seed=SEED, seq=4)
    assert np.array_equal(buf.numpy(), want)


def test_verify_view_catches_mutated_buffer_and_copies_the_payload():
    arr = _sample(np.int32, (300,))
    buf = torch.empty((framing.frame_rows(arr.nbytes), framing.LANES),
                      dtype=torch.uint32)
    rows = framing.seal_into(buf, arr, seed=SEED, seq=0)
    out = framing.verify_view(buf[:rows], seed=SEED, expect_seq=0)
    words = buf.view(torch.int32)
    words[2, 17] ^= 1 << 4              # a payload bit after sealing
    assert np.array_equal(out.numpy(), arr)     # the handed-out copy holds
    with pytest.raises(framing.FrameError, match="MAC"):
        framing.verify_view(buf[:rows], seed=SEED, expect_seq=0)
    words[2, 17] ^= 1 << 4
    framing.verify_view(buf[:rows], seed=SEED, expect_seq=0)
    words[rows - 1, framing.LANES - 1] ^= 1     # the pad is MAC-covered
    with pytest.raises(framing.FrameError):
        framing.verify_view(buf[:rows], seed=SEED, expect_seq=0)


def test_seal_into_rejects_bad_buffers():
    arr = _sample(np.uint8, (4096,))
    with pytest.raises(framing.FrameError, match="too small"):
        framing.seal_into(torch.empty((2, framing.LANES), dtype=torch.uint32),
                          arr, seed=SEED, seq=0)
    with pytest.raises(framing.FrameError):
        framing.seal_into(torch.empty((9, 64), dtype=torch.uint32), arr,
                          seed=SEED, seq=0)
    with pytest.raises(framing.FrameError):
        framing.seal_into(torch.empty((9, framing.LANES), dtype=torch.int32),
                          arr, seed=SEED, seq=0)
    strided = torch.empty((18, framing.LANES), dtype=torch.uint32)[::2]
    with pytest.raises(framing.FrameError, match="contiguous"):
        framing.seal_into(strided, arr, seed=SEED, seq=0)


def test_frame_stats_hook_counts_copies():
    """A seal writes the payload once; the receive guard writes one
    protected copy of the payload rows."""
    stats0 = framing.STATS.snapshot()
    arr = _sample(np.uint8, (2048,))
    buf = torch.empty((framing.frame_rows(arr.nbytes), framing.LANES),
                      dtype=torch.uint32)
    rows = framing.seal_into(buf, arr, seed=SEED, seq=0)
    framing.verify_view(buf[:rows], seed=SEED, expect_seq=0)
    d = {k: v - stats0[k] for k, v in framing.STATS.snapshot().items()}
    assert d["frames_sealed"] == 1 and d["frames_sealed_inplace"] == 1
    assert d["bytes_copied"] == arr.nbytes + (rows - 1) * framing.LANES * 4
    assert d["concat_calls"] == 0
    assert d["views_returned"] == 1 and d["frames_verified"] == 1


# ---------------------------------------------------------------------------
# the arena and the ring (tests/test_zero_copy.py's ring section)
# ---------------------------------------------------------------------------

def test_arena_reuses_a_slot_only_after_release():
    arena = framing.FrameArena(rows=256, device="cpu")
    a = arena.acquire(3)                # class 16
    b = arena.acquire(17)               # class 32
    assert a.shape == (16, framing.LANES) and b.shape == (32, framing.LANES)
    assert arena.offset_rows(a) == 0 and arena.offset_rows(b) == 16
    others = [arena.acquire(16) for _ in range(3)]
    assert all(arena.offset_rows(o) not in (0, 16) for o in others)
    arena.release(a)
    assert arena.free_slots() == 1
    again = arena.acquire(2)
    assert arena.offset_rows(again) == 0        # the released slot, reused
    arena.release(again)
    with pytest.raises(framing.FrameError, match="not out"):
        arena.release(again)            # released twice
    with pytest.raises(framing.FrameError, match="not a row-aligned slot"):
        arena.release(torch.empty((16, framing.LANES), dtype=torch.uint32))
    with pytest.raises(framing.FrameError, match="exhausted"):
        arena.acquire(256)


def test_arena_slots_share_one_backing():
    arena = framing.FrameArena(rows=64, device="cpu")
    a, b = arena.acquire(16), arena.acquire(16)
    assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    assert b.data_ptr() - a.data_ptr() == 16 * framing.LANES * 4


@pytest.mark.parametrize("cls", [ShmTransport, MPKLinkOptTransport])
def test_ring_poll_payloads_survive_slot_recycling(cls):
    """A payload handed back by poll() never changes when traffic reuses
    its slot many times over."""
    tr = _cpu(cls, lambda r: r, ring_slots=4)
    s = tr.connect("viewer")
    try:
        t0 = s.submit(make_text(100, seed=1))
        s.flush()
        held = s.poll(t0)
        expected = held.clone()
        free0 = tr.arena.free_slots()
        for i in range(12):
            t = s.submit(make_text(50 + i, seed=i))
            s.flush()
            s.poll(t)
        assert tr.arena.free_slots() >= free0       # slots were reused
        assert torch.equal(held, expected)
    finally:
        tr.close()


def test_call_batch_payloads_never_alias_slots():
    tr = _cpu(MPKLinkOptTransport, lambda r: r, ring_slots=4)
    s = tr.connect("batch-alias")
    try:
        first = s.call_batch([np.full(64, 7, np.uint8), np.full(64, 9, np.uint8)])
        for _ in range(6):              # churn that reuses the slots
            s.call_batch([np.full(64, 255, np.uint8)] * 4)
        assert first[0].tolist() == [7] * 64 and first[1].tolist() == [9] * 64
    finally:
        tr.close()


def test_ring_arena_recycles_slots():
    tr = _cpu(MPKLinkOptTransport, ring_slots=4)
    s = tr.connect("recycler")
    try:
        st0 = framing.STATS.snapshot()
        for _ in range(8):
            outs = s.call_batch([make_text(20 + j, seed=j) for j in range(3)])
            assert [parse_count(o) for o in outs] == [20, 21, 22]
        d = {k: v - st0[k] for k, v in framing.STATS.snapshot().items()}
        assert tr.arena.free_slots() > 0
        assert d["arena_reused"] > d["arena_allocated"]
        assert d["arena_released"] == d["arena_reused"] + d["arena_allocated"]
    finally:
        tr.close()


def test_full_arena_surfaces_as_capacity_error():
    tr = _cpu(MPKLinkOptTransport)
    tr.arena = framing.FrameArena(rows=32, device="cpu")
    s = tr.connect("small-arena")
    try:
        with pytest.raises(CapacityError, match="exhausted"):
            s.submit(make_text(10_000, seed=0))
        assert parse_count(s.request(make_text(10_000, seed=0))) == 10_000
    finally:
        tr.close()
