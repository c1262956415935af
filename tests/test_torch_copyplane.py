"""The legacy copy plane (``framing.ZERO_COPY = False``) of the port against
the reference's, on the CPU.

Held: legacy frames bit-identical to the in-place ones for every dtype
code and to the reference's legacy frames; the legacy MACs (the earlier
two-launch designs, whose plain versions run here) equal to the
reference's ``legacy_fast_mac`` / ``_mac_batch_np_legacy`` over several
block splits; the reference's ``test_frame_stats_hook_counts_copies`` and
``test_legacy_mode_interoperates_on_the_wire`` through the port; for
``build_frame``, one mpklink_opt ``request``, a ring ``submit``/``poll``
and a ring ``call_batch``, and the gateway's ``call``, ``call_batch`` and
``call_many``: the port's ``concat_calls`` a legacy operation equal to the
reference's, and its legacy-minus-in-place ``bytes_copied`` equal to the
reference's; frames crossed both ways in legacy mode; the gateway
benchmark's payload cell in both planes."""
import numpy as np
import pytest
import torch

from repro.core import ServiceGateway as JGateway
from repro.core import framing as jf
from repro.core import transports as jt
from repro.core.wordcount import wordcount_handler as j_wordcount

from repro_torch.core import ServiceGateway, framing
from repro_torch.core.transports import MPKLinkOptTransport
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler
from repro_torch.kernels import ops
from repro_torch.launch import gateway_bench as gb

SEED = 0x5EED1234


@pytest.fixture(autouse=True)
def _restore_zero_copy():
    before = framing.ZERO_COPY, jf.ZERO_COPY
    yield
    framing.ZERO_COPY, jf.ZERO_COPY = before


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sample(dtype, shape):
    n = int(np.prod(shape, dtype=np.int64))
    base = np.arange(max(n, 1), dtype=np.int64) % 251
    return base[:n].astype(dtype).reshape(shape)


def _u32(rows, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (rows, 128), dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# frames and MACs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", sorted(jf._DTYPES))
def test_legacy_build_frame_bit_identical_every_dtype(code):
    dtype = jf._DTYPES[code]
    for shape in [(0,), (1,), (13,), (128,), (3, 4), (2, 3, 4), (513,), (2, 2, 2, 2)]:
        arr = _sample(dtype, shape)
        for seq, dl, prio in ((0, 0, 0), (7, 1500, framing.PRIO_HIGH)):
            framing.ZERO_COPY = True
            inplace = framing.build_frame(arr, seed=SEED, seq=seq, deadline_us=dl,
                                          priority=prio, device="cpu")
            framing.ZERO_COPY = False
            legacy = framing.build_frame(arr, seed=SEED, seq=seq, deadline_us=dl,
                                         priority=prio, device="cpu")
            jf.ZERO_COPY = False
            theirs = jf.build_frame(arr, seed=SEED, seq=seq, deadline_us=dl,
                                    priority=prio)
            assert legacy.dtype == torch.uint32 and legacy.is_contiguous()
            assert np.array_equal(legacy.numpy(), inplace.numpy()), (code, shape)
            assert np.array_equal(legacy.numpy(), theirs), (code, shape)


def test_legacy_build_frame_from_a_tensor_at_an_odd_offset():
    """A uint8 tensor view that starts off 4-byte alignment is staged (one
    counted copy) before it is viewed as words: the same frame."""
    raw = torch.from_numpy(_sample(np.uint8, (1025,)))[1:]
    framing.ZERO_COPY = False
    st0 = framing.STATS.snapshot()
    legacy = framing.build_frame(raw, seed=SEED, seq=1, device="cpu")
    d = framing.STATS.snapshot()["bytes_copied"] - st0["bytes_copied"]
    assert d == 1024 + 1024 + 512            # staging, header concat (no pad)
    framing.ZERO_COPY = True
    assert torch.equal(legacy, framing.build_frame(raw, seed=SEED, seq=1,
                                                   device="cpu"))


@pytest.mark.parametrize("rows,block_rows", [(1, 65536), (7, 3), (64, 64),
                                             (300, 128), (513, 1), (1000, 999)])
def test_legacy_fast_mac_matches_the_reference(rows, block_rows):
    p = _u32(rows, rows)
    want = jt.legacy_fast_mac(p, SEED, block_rows)
    framing.ZERO_COPY = False
    assert framing.fast_mac(torch.from_numpy(p), SEED, block_rows) == want
    assert framing.legacy_fast_mac(torch.from_numpy(p), SEED, block_rows) == want
    framing.ZERO_COPY = True
    assert framing.fast_mac(torch.from_numpy(p), SEED, block_rows) == want


@pytest.mark.parametrize("frames,rows,block_rows", [(1, 1, 65536), (3, 5, 2),
                                                    (8, 64, 7), (4, 300, 128)])
def test_legacy_mac_batch_matches_the_reference(frames, rows, block_rows):
    stack = np.stack([_u32(rows, 100 + i) for i in range(frames)])
    want = jf._mac_batch_np_legacy(stack, SEED, block_rows).tolist()
    framing.ZERO_COPY = False
    got = framing.mac_batch([torch.from_numpy(s) for s in stack], SEED)
    assert got == want
    # ragged row counts group apart: each group's words are the same
    mixed = [torch.from_numpy(_u32(r, r)) for r in (1, 3, 1, 5, 3)]
    assert framing.mac_batch(mixed, SEED) == [
        jt.legacy_fast_mac(m.numpy(), SEED) for m in mixed]


def test_two_pass_entry_points_run_their_plain_versions_on_the_cpu():
    p = torch.from_numpy(_u32(40, 3))
    before = ops.LAUNCHES.snapshot()
    h = ops.mac_init_state(SEED, "cpu")
    assert torch.equal(ops.mac_update_two_pass(h, p), ops.mac_update(h, p))
    st = p.reshape(2, 20, 128)
    assert torch.equal(ops.mac_batch_two_pass(st, SEED), ops.mac_batch(st, SEED))
    assert ops.LAUNCHES.snapshot() == before        # no launch on the CPU
    assert {"mac_batch_two_pass", "mac_update_two_pass"} <= set(before)
    meta = torch.empty((2, 20, 128), dtype=torch.uint32, device="meta")
    assert ops.mac_batch_two_pass(meta, SEED).shape == (2,)
    assert ops.mac_update_two_pass(torch.empty(128, dtype=torch.uint32,
                                               device="meta"), meta[0]).shape == (128,)


def test_seal_batch_legacy_equals_seal_batch():
    arrays = [_sample(np.float32, (5,)), _sample(np.uint8, (512,)),
              _sample(np.int64, (0,)), _sample(np.uint16, (700,))]
    framing.ZERO_COPY = False
    legacy = framing.seal_batch_legacy(arrays, seed=SEED, seqs=[3, 4, 9, 5],
                                       device="cpu")
    framing.ZERO_COPY = True
    inplace = framing.seal_batch(arrays, seed=SEED, seqs=[3, 4, 9, 5], device="cpu")
    assert [f.shape for f in legacy] == [f.shape for f in inplace]
    assert all(torch.equal(a, b) for a, b in zip(legacy, inplace))


# ---------------------------------------------------------------------------
# the reference's two tests, under their own names
# ---------------------------------------------------------------------------

def test_frame_stats_hook_counts_copies():
    stats0 = framing.STATS.snapshot()
    arr = _sample(np.uint8, (2048,))
    buf = torch.empty((framing.frame_rows(arr.nbytes), framing.LANES),
                      dtype=torch.uint32)
    rows = framing.seal_into(buf, arr, seed=SEED, seq=0)
    framing.verify_view(buf[:rows], seed=SEED, expect_seq=0)
    d = {k: v - stats0[k] for k, v in framing.STATS.snapshot().items()}
    assert d["frames_sealed"] == 1 and d["frames_sealed_inplace"] == 1
    # one payload write by the seal; the port's verify adds its guarded copy
    assert d["bytes_copied"] == arr.nbytes + (rows - 1) * framing.LANES * 4
    assert d["concat_calls"] == 0
    assert d["views_returned"] == 1
    # the legacy path is measurably copy-heavier — that's the bench baseline
    framing.ZERO_COPY = False
    stats1 = framing.STATS.snapshot()
    framing.build_frame(arr, seed=SEED, seq=0, device="cpu")
    d2 = {k: v - stats1[k] for k, v in framing.STATS.snapshot().items()}
    assert d2["concat_calls"] >= 1 and d2["bytes_copied"] > arr.nbytes


def test_legacy_mode_interoperates_on_the_wire():
    """A legacy-built exchange and an in-place one share one session and
    its sequence: both sides accept either."""
    tr = MPKLinkOptTransport(wordcount_handler, device="cpu")
    s = tr.connect("mixed")
    try:
        framing.ZERO_COPY = False
        assert parse_count(s.request(make_text(5, seed=0))) == 5
        framing.ZERO_COPY = True
        assert parse_count(s.request(make_text(6, seed=0))) == 6
        framing.ZERO_COPY = False
        assert parse_count(s.poll(s.submit(make_text(7, seed=1)))) == 7
        assert [parse_count(r) for r in s.call_batch(
            [make_text(n, seed=n) for n in (2, 3, 4)])] == [2, 3, 4]
        framing.ZERO_COPY = True
        assert parse_count(s.request(make_text(8, seed=2))) == 8
        assert s._seq == 7
    finally:
        tr.close()


# ---------------------------------------------------------------------------
# counters a legacy operation, against the reference's
# ---------------------------------------------------------------------------

def _digest(req):
    return np.asarray([int(np.asarray(req).reshape(-1).view(np.uint8)
                           .sum(dtype=np.uint64))], np.uint64)


def _digest_port(req):
    return req.reshape(-1).view(torch.uint8).sum(dtype=torch.int64).reshape(1)


def _deltas(stats, zero_copy_flag, set_flag, fn):
    """Counter deltas of one ``fn()`` in each plane (after a warm-up call
    in that plane) → {plane: (concat_calls, bytes_copied)}."""
    out = {}
    for zc in (True, False):
        set_flag(zc)
        fn()
        s0 = stats.snapshot()
        fn()
        s1 = stats.snapshot()
        out[zc] = (s1["concat_calls"] - s0["concat_calls"],
                   s1["bytes_copied"] - s0["bytes_copied"])
    set_flag(True)
    return out


def _ops(build, p, s, c):
    """The operations counted, through one package's session ``s`` and
    gateway client ``c``; ``build`` is its ``build_frame``."""
    return {"build_frame": lambda: build(p, seed=1, seq=0),
            "request": lambda: s.request(p),
            "submit_poll": lambda: s.poll(s.submit(p)),
            "ring_call_batch": lambda: s.call_batch([p] * 3),
            "call": lambda: c.call("digest", p),
            "call_batch": lambda: c.call_batch("digest", [p] * 4),
            "call_many": lambda: c.call_many([("digest", p), ("d2", p), ("digest", p)])}


def _setter(mod):
    def set_flag(zc):
        mod.ZERO_COPY = zc
    return set_flag


OPS = ("build_frame", "request", "submit_poll", "ring_call_batch", "call",
       "call_batch", "call_many")


@pytest.mark.parametrize("nbytes", [1000, 4096, 65536])
def test_legacy_counters_a_operation_equal_the_reference(nbytes):
    p = (np.arange(nbytes) % 251).astype(np.uint8)
    got = {}
    for name, mod, make_tr, make_gw, digest, build in (
            ("port", framing, lambda: MPKLinkOptTransport(_digest_port, device="cpu"),
             lambda: ServiceGateway("mpklink_opt", device="cpu"), _digest_port,
             lambda *a, **k: framing.build_frame(*a, device="cpu", **k)),
            ("ref", jf, lambda: jt.MPKLinkOptTransport(_digest),
             lambda: JGateway("mpklink_opt"), _digest, jf.build_frame)):
        tr = make_tr()
        s = tr.connect("x")
        gw = make_gw()
        gw.register_service("digest", digest)
        gw.register_service("d2", digest)
        gw.start()
        c = gw.connect("c")
        try:
            ops_ = _ops(build, p, s, c)
            got[name] = {op: _deltas(mod.STATS, mod, _setter(mod), ops_[op])
                         for op in OPS}
        finally:
            c.close()
            gw.close()
            tr.close()
    for op in OPS:
        mine, theirs = got["port"][op], got["ref"][op]
        assert mine[True][0] == 0 and theirs[True][0] == 0, op
        assert mine[False][0] == theirs[False][0], (op, mine, theirs)
        assert (mine[False][1] - mine[True][1]
                == theirs[False][1] - theirs[True][1]), (op, mine, theirs)
    assert got["port"]["call"][False][0] >= 1


# ---------------------------------------------------------------------------
# crossed frames and the benchmark cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arr", [_sample(np.float32, (3, 5)), _sample(np.uint8, (1000,)),
                                 _sample(np.int64, (0,)), _sample(np.uint16, (512,))],
                         ids=["f32", "u8-pad", "empty", "u16-aligned"])
def test_legacy_frames_cross_verify(arr):
    framing.ZERO_COPY = jf.ZERO_COPY = False
    ours = framing.build_frame(arr, seed=SEED, seq=4, priority=framing.PRIO_BULK,
                               device="cpu")
    back = jf.parse_frame(ours.numpy(), seed=SEED, expect_seq=4)
    assert back.dtype == arr.dtype and np.array_equal(back, arr)
    theirs = jf.build_frame(arr, seed=SEED, seq=5, priority=framing.PRIO_BULK)
    got = framing.verify_view(torch.from_numpy(theirs), seed=SEED, expect_seq=5)
    assert got.numpy().dtype == arr.dtype and np.array_equal(got.numpy(), arr)
    bad = torch.from_numpy(theirs.copy())
    if bad.shape[0] > 1:
        bad[1, 0] ^= 1
        with pytest.raises(framing.FrameError):
            framing.verify_view(bad, seed=SEED, expect_seq=5)


def test_legacy_gateway_serves_the_reference_wordcount():
    """The port's gateway in the legacy plane answers as the in-place one
    does (the reference's wordcount handler takes the host bytes)."""
    gw = ServiceGateway("mpklink_opt", device="cpu")
    gw.register_service("wc", lambda r: j_wordcount(r.numpy()))
    gw.start()
    try:
        c = gw.connect("legacy")
        framing.ZERO_COPY = False
        assert parse_count(c.call("wc", make_text(11, seed=3))) == 11
        assert [parse_count(r) for r in c.call_batch(
            "wc", [make_text(n, seed=n) for n in (1, 2)])] == [1, 2]
        assert [parse_count(r) for r in c.call_many(
            [("wc", make_text(4, seed=4)), ("wc", make_text(9, seed=9))])] == [4, 9]
        framing.ZERO_COPY = True
        assert parse_count(c.call("wc", make_text(12, seed=3))) == 12
    finally:
        gw.close()


def test_payload_cell_in_both_planes():
    gw = ServiceGateway("mpklink_opt", max_keys=64, device="cpu")
    gw.register_service("digest", gb.digest_handler)
    gw.start()
    try:
        cells = {zc: gb.run_payload_cell(gw, 64 * 1024, 2, zc, gb.PAYLOAD_IN_FLIGHT)
                 for zc in (False, True)}
    finally:
        gw.close()
    assert framing.ZERO_COPY is True                  # restored by the cell
    assert cells[True]["mode"] == "zero_copy" and cells[False]["mode"] == "legacy"
    assert cells[True]["concat_calls_per_request"] == 0
    assert cells[False]["concat_calls_per_request"] >= 1
    assert (cells[False]["bytes_copied_per_request"]
            > cells[True]["bytes_copied_per_request"])
    assert all(c["requests"] == 2 * gb.PAYLOAD_IN_FLIGHT
               and c["macs_verified_clients"] >= c["requests"] for c in cells.values())
    for c in cells.values():
        c["transport"] = "mpklink_opt"
    speed = gb.payload_speedup(list(cells.values()))
    assert list(speed) == [f"mpklink_opt/64KiB/k{gb.PAYLOAD_IN_FLIGHT}"]
    assert speed[f"mpklink_opt/64KiB/k{gb.PAYLOAD_IN_FLIGHT}"] > 0
    assert gb.zero_copy_gate(speed) in (True, False)
    assert gb.zero_copy_gate({}) is None


# ---------------------------------------------------------------------------
# launches a legacy envelope, counted through the plain versions
# ---------------------------------------------------------------------------

GUARD = ("guard_copy", "mac_batch", "mac_init_state", "mac_update", "mac_finalize",
         "mac_batch_two_pass", "mac_update_two_pass")


@pytest.fixture
def counted(monkeypatch):
    """The guard kernels' calls on CPU tensors run their plain versions and
    are counted as the card counts its launches (the two-launch designs
    too), so the arithmetic answers as it does for the card."""
    from repro_torch.kernels import mpk_guard as _mg
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    for name in ("guard_copy", "mac_batch", "mac_update", "mac_finalize"):
        monkeypatch.setattr(_mg, f"{name}_cuda", getattr(_mg, f"{name}_plain"))
    monkeypatch.setattr(_mg, "_mac_batch_two_pass", _mg.mac_batch_plain)
    monkeypatch.setattr(_mg, "_mac_update_two_pass", _mg.mac_update_plain)

    def mac_init_state(tag, device):
        ops.LAUNCHES.bump("mac_init_state")
        return _mg.mac_init_state_plain(tag, torch.device(device))

    monkeypatch.setattr(ops, "mac_init_state", mac_init_state)
    monkeypatch.setattr(gb, "_on_card", lambda device: True)
    gw = ServiceGateway("mpklink_opt", device="cpu")
    gw.register_service("digest", gb.digest_handler)
    gw.start()
    client = gw.connect("counter")
    client.open("digest")
    yield gw, client
    gw.close()


def _count(fn):
    ops.LAUNCHES.reset()
    out = fn()
    return out, {k: v for k, v in ops.LAUNCHES.snapshot().items() if k in GUARD and v}


@pytest.mark.parametrize("zero_copy", [False, True])
@pytest.mark.parametrize("nbytes", [1000, 64 * 1024])
def test_envelope_launches_in_both_planes(counted, zero_copy, nbytes):
    """The launches of ``call``, ``call_batch`` and ``call_many`` in each
    plane: the same structure, the legacy plane's MACs by the two-launch
    kernels (``zero_copy=False`` of the arithmetic) — the counts the card run's
    copyplane phase holds exactly."""
    gw, client = counted
    p = (np.arange(nbytes) % 251).astype(np.uint8)
    framing.ZERO_COPY = zero_copy
    out, got = _count(lambda: client.call("digest", p))
    assert int(out[0]) == int(p.astype(np.int64).sum())
    assert got == gb.single_launches(nbytes, 8, "cuda", zero_copy)
    outs, got = _count(lambda: client.call_batch("digest", [p] * 4))
    assert [int(o[0]) for o in outs] == [int(p.astype(np.int64).sum())] * 4
    assert got == gb.batch_launches([nbytes] * 4, [8] * 4, "cuda", zero_copy)
    _, got = _count(lambda: client.call_many([("digest", p), ("digest", p[:100])]))
    assert got == gb.scatter_launches(
        [("digest", nbytes, 8), ("digest", 100, 8)], "cuda", zero_copy)
    names = set(got)
    assert not names & ({"mac_update", "mac_batch"} if not zero_copy
                        else {"mac_update_two_pass", "mac_batch_two_pass"})
