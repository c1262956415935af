"""The port's framing against ``repro.core.framing``: frames sealed by the two
packages are identical byte for byte, each parses under the other, tampered
bits raise ``FrameError``, and the batch path keeps per-item errors."""
import numpy as np
import pytest
import torch

from repro.core import framing as jf
from repro.core import transports as jt

from repro_torch.core import framing as pf
from repro_torch.core import transports as pt

SEED = 0xC0FFEE11

ARRAYS = [
    np.arange(15, dtype=np.float32).reshape(3, 5),
    np.arange(-3, 4, dtype=np.int32),
    (np.arange(1000) % 251).astype(np.uint8),
    np.linspace(-1, 1, 24).reshape(2, 3, 4),                 # float64
    np.array([2 ** 40, -5, 7], np.int64),
    np.arange(9, dtype=np.uint16),
    np.arange(128, dtype=np.uint32) * 0x01010101,
    np.zeros((0,), np.float32),                              # header-only
    np.ones((2, 2, 2, 2), np.float32),
    np.arange(300, dtype=np.int32).reshape(300),             # > 1 payload row
]
META = [(0, 0, jf.PRIO_NORMAL), (7, 1500, jf.PRIO_HIGH), (2 ** 32 - 1, 0, jf.PRIO_BULK)]


def _pframe(arr, seq=0, deadline_us=0, priority=0):
    return pf.build_frame(arr, seed=SEED, seq=seq, deadline_us=deadline_us,
                          priority=priority, device="cpu")


@pytest.mark.parametrize("i", range(len(ARRAYS)))
@pytest.mark.parametrize("seq,deadline_us,priority", META)
def test_frames_identical_and_cross_parse(i, seq, deadline_us, priority):
    arr = ARRAYS[i]
    ours = _pframe(arr, seq, deadline_us, priority)
    theirs = jf.build_frame(arr, seed=SEED, seq=seq, deadline_us=deadline_us,
                            priority=priority)
    assert ours.dtype == torch.uint32
    assert np.array_equal(ours.numpy(), theirs)
    back = jf.parse_frame(ours.numpy(), seed=SEED, expect_seq=seq)
    assert back.dtype == arr.dtype and np.array_equal(back, arr)
    got = pf.verify_view(torch.from_numpy(theirs), seed=SEED, expect_seq=seq)
    assert np.array_equal(got.numpy(), arr) and got.numpy().dtype == arr.dtype
    assert pf.frame_deadline_us(ours) == deadline_us
    assert pf.frame_priority(ours) == priority


def test_seal_from_tensor_and_into_buffer():
    arr = ARRAYS[0]
    buf = torch.full((8, 128), 0xFFFFFFFF, dtype=torch.int64).to(torch.uint32)
    rows = pf.seal_into(buf, torch.from_numpy(arr), seed=SEED, seq=3)
    assert rows == pf.frame_rows(arr.nbytes) == 2
    assert np.array_equal(buf[:rows].numpy(), jf.build_frame(arr, seed=SEED, seq=3))
    assert (buf[rows:].numpy() == 0xFFFFFFFF).all()        # untouched
    with pytest.raises(pf.FrameError):
        pf.seal_into(buf[:1], arr, seed=SEED, seq=3)        # too small


@pytest.mark.parametrize("row,lane,what", [
    (1, 0, "payload"), (2, 127, "payload"), (0, 3, "nbytes"),
    (0, 4, "dtype"), (0, 6, "shape"), (0, 10, "deadline"), (0, 11, "mac"),
    (0, 12, "priority"), (0, 20, "reserved"), (0, 0, "magic"), (0, 1, "seed"),
    (0, 2, "seq")])
def test_tampered_bits_raise(row, lane, what):
    frame = _pframe(ARRAYS[9], seq=5)
    frame[row, lane] ^= 1
    with pytest.raises(pf.FrameError):
        pf.verify_view(frame, seed=SEED, expect_seq=5)
    with pytest.raises(jf.FrameError):                      # same verdict
        jf.parse_frame(frame.numpy(), seed=SEED, expect_seq=5)


def test_wrong_seed_seq_and_malformed_raise():
    frame = _pframe(ARRAYS[1], seq=1)
    with pytest.raises(pf.FrameError, match="seed"):
        pf.verify_view(frame, seed=SEED + 1)
    with pytest.raises(pf.FrameError, match="sequence"):
        pf.verify_view(frame, seed=SEED, expect_seq=2)
    with pytest.raises(pf.FrameError, match="malformed"):
        pf.verify_view(frame[:, :64].contiguous(), seed=SEED)
    with pytest.raises(pf.FrameError, match="MAC"):         # truncated rows
        pf.verify_view(_pframe(ARRAYS[9])[:2].contiguous(), seed=SEED)
    with pytest.raises(pf.FrameError):
        _pframe(np.zeros(3, np.bool_))


def test_seal_batch_identical_and_verify_batch_keeps_item_errors():
    arrays = [ARRAYS[0], ARRAYS[2], ARRAYS[7], ARRAYS[1], ARRAYS[9]]
    ours = pf.seal_batch(arrays, seed=SEED, start_seq=10,
                         priorities=[0, 1, 2, 0, 1], device="cpu")
    theirs = jf.seal_batch(arrays, seed=SEED, start_seq=10,
                           priorities=[0, 1, 2, 0, 1])
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.numpy(), b)
    ours[1][1, 7] ^= 1                                      # payload tamper
    ours[3][0, 2] ^= 1                                      # seq tamper
    got = pf.verify_batch(ours, seed=SEED, start_seq=10, strict=False)
    assert isinstance(got[1], pf.FrameError) and isinstance(got[3], pf.FrameError)
    for i in (0, 2, 4):
        assert np.array_equal(got[i].numpy(), arrays[i])
    with pytest.raises(pf.FrameError, match="frame 3"):   # prechecks first
        pf.verify_batch(ours, seed=SEED, start_seq=10)
    # reference frames verify under the port's batch path
    got = pf.verify_batch([torch.from_numpy(f) for f in theirs], seed=SEED,
                          seqs=list(range(10, 15)))
    assert all(np.array_equal(g.numpy(), a) for g, a in zip(got, arrays))


def test_mac_batch_matches_reference_grouping():
    payloads = [pf.pack_payload(a, device="cpu")[0] for a in ARRAYS]
    assert pf.mac_batch(payloads, SEED) == \
        jf.mac_batch([p.numpy() for p in payloads], SEED)


def test_split_frames_walks_an_envelope():
    frames = [_pframe(a, seq=i) for i, a in enumerate(ARRAYS[:4])]
    parts = pf.split_frames(torch.cat(frames))
    assert [p.shape[0] for p in parts] == [f.shape[0] for f in frames]
    assert all(torch.equal(p, f) for p, f in zip(parts, frames))
    flat = torch.cat(frames)
    flat[0, 3] = 10 ** 6                                    # corrupted length
    with pytest.raises(pf.FrameError):
        pf.split_frames(flat)


@pytest.mark.parametrize("rows,block_rows", [(0, 4), (1, 4), (10, 3), (64, 64),
                                             (65, 64)])
def test_fast_mac_matches_reference(rows, block_rows):
    p = np.random.default_rng(rows).integers(0, 2 ** 32, (rows, 128),
                                             dtype=np.uint32)
    assert pt.fast_mac(torch.from_numpy(p), SEED, block_rows) == \
        jt.fast_mac(p, SEED, block_rows) == jf._mac_np(p, SEED)


def test_deadline_words_match_reference():
    for s in (None, -1.0, 0.0, 1e-7, 0.25, 1e9):
        assert pf.deadline_to_us(s) == jf.deadline_to_us(s)
