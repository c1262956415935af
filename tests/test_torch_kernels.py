"""The port's kernels on the CPU (their plain versions) against the JAX
reference: the guard MAC family bit for bit against the Pallas kernels (in
interpret mode) and the host MACs of ``repro.core.framing``; decode
attention against ``decode_attention_pallas`` and ``attention_ref`` at the
reference's own tolerances (2e-5 in f32, 2e-2 in bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import framing as jframing
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.mpk_guard import mac_batch_pallas, mac_update_pallas
from repro.kernels.ref import attention_ref as jattention_ref
from repro.kernels.ref import mac_ref as jmac_ref

from repro_torch.kernels import decode_attention as pda
from repro_torch.kernels import mpk_guard as pmg
from repro_torch.kernels import ops


def _payload(rows, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (rows, 128), dtype=np.uint32)


def _jmac(p, tag):
    return int(jmac_ref(jnp.asarray(p), jnp.uint32(tag)))


# -- guard_copy -----------------------------------------------------------------

# the row/tile cases of tests/test_kernels_guard.py
@pytest.mark.parametrize("rows,tile", [(4, 4), (8, 4), (256, 64), (32, 32), (7, 4)])
def test_guard_copy_matches_pallas(rows, tile):
    p = _payload(rows)
    tag = 42
    want = _jmac(p, tag)
    out_j, mac_j, ok_j = jops.guard_copy(jnp.asarray(p), jnp.uint32(tag),
                                         jnp.uint32(want), rows_per_tile=tile)
    out, mac, ok = ops.guard_copy(torch.from_numpy(p), tag, want)
    assert np.array_equal(out.numpy(), np.asarray(out_j))
    assert mac.tolist() == [int(mac_j[0])] == [want]
    assert ok.tolist() == [int(ok_j[0])] == [1]
    assert want == jframing._mac_np(p, tag)


def test_guard_copy_zero_rows():
    """A header-only frame's payload has 0 rows: its MAC is the fold of h0."""
    p = _payload(0)
    want = jframing._mac_np(p, 7)
    out, mac, ok = ops.guard_copy(torch.from_numpy(p), 7, want)
    assert out.shape == (0, 128)
    assert mac.tolist() == [want] and ok.tolist() == [1]


def test_guard_copy_returns_a_copy():
    p = torch.from_numpy(_payload(4))
    out, _, _ = ops.guard_copy(p, 1, 0)
    p[0, 0] ^= 1
    assert int(out[0, 0]) != int(p[0, 0])


def test_wrong_tag_rejected():
    p = _payload(16)
    _, _, ok = ops.guard_copy(torch.from_numpy(p), 2, _jmac(p, 1))
    assert ok.tolist() == [0]


@pytest.mark.parametrize("row,lane", [(0, 0), (7, 127), (3, 64)])
def test_single_bit_tamper_rejected(row, lane):
    p = _payload(8, seed=3)
    mac = _jmac(p, 9)
    p[row, lane] ^= 1
    _, got, ok = ops.guard_copy(torch.from_numpy(p), 9, mac)
    assert ok.tolist() == [0]
    assert got.tolist() == [jframing._mac_np(p, 9)]


# -- mac_batch ------------------------------------------------------------------

@pytest.mark.parametrize("n,rows", [(1, 1), (3, 4), (5, 9), (2, 256)])
def test_mac_batch_matches_pallas(n, rows):
    stack = np.stack([_payload(rows, seed=i) for i in range(n)])
    got = ops.mac_batch(torch.from_numpy(stack), 77).tolist()
    assert got == np.asarray(mac_batch_pallas(jnp.asarray(stack),
                                              jnp.uint32(77))).tolist()
    assert got == jframing.mac_batch(list(stack), 77)


def test_mac_batch_zero_rows():
    stack = np.zeros((3, 0, 128), np.uint32)
    got = ops.mac_batch(torch.from_numpy(stack), 5).tolist()
    assert got == jframing.mac_batch(list(stack), 5)


# -- streaming MAC ----------------------------------------------------------------

@pytest.mark.parametrize("cuts", [(0, 37), (0, 5, 37), (0, 0, 12, 12, 37),
                                  (0, 1, 2, 36, 37)])
def test_mac_update_any_split_is_one_shot(cuts):
    p = _payload(37, seed=11)
    tag = 0xDEADBEEF
    h = ops.mac_init_state(tag, "cpu")
    hj = jnp.full((128,), 0x811C9DC5, jnp.uint32) + jnp.uint32(tag)
    hn = jframing.mac_init_np(tag)
    assert h.tolist() == np.asarray(hj).tolist()
    for a, b in zip(cuts, cuts[1:]):
        blk = p[a:b]
        h = ops.mac_update(h, torch.from_numpy(blk))
        hj = mac_update_pallas(hj, jnp.asarray(blk))
        hn = jframing.mac_update_np(hn, blk)
        assert h.tolist() == np.asarray(hj).tolist() == hn.tolist()
    assert ops.mac_finalize(h).tolist() == [_jmac(p, tag)]


def test_plain_twins_agree_with_reference_finalize():
    h = np.random.default_rng(4).integers(0, 2 ** 32, 128, dtype=np.uint32)
    assert pmg.mac_finalize_plain(torch.from_numpy(h)).tolist() == \
        [jframing.mac_finalize_np(h)]


# -- dispatch -------------------------------------------------------------------

def test_no_route_for_other_devices():
    meta = torch.empty((2, 128), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError):
        ops.guard_copy(meta, 0, 0)
    with pytest.raises(ValueError):
        ops.mac_init_state(0, "meta")


def test_cuda_launchers_refuse_cpu_tensors():
    p = torch.from_numpy(_payload(2))
    with pytest.raises(ValueError):
        pmg.guard_copy_cuda(p, 0, 0)
    q = torch.zeros((1, 1, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        pda.decode_attention_cuda(q, k, k, torch.zeros((1, 1), dtype=torch.int32),
                                  torch.zeros((1, 8), dtype=torch.int32))


def test_cpu_calls_count_no_launches():
    ops.LAUNCHES.reset()
    ops.guard_copy(torch.from_numpy(_payload(2)), 0, 0)
    assert sum(ops.LAUNCHES.snapshot().values()) == 0


@pytest.mark.parametrize("B,S,Hkv", [(8, 1024, 8), (1, 64, 1), (3, 1000, 2),
                                     (64, 128, 8), (1, 1, 1), (8, 16384, 8),
                                     (64, 1024, 8), (1, 131072, 1), (2, 4096, 2),
                                     (1, 1 << 22, 1)])
@pytest.mark.parametrize("slots", [pda.TARGET_BLOCKS, 264, 132])
def test_split_plan_covers_the_cache(B, S, Hkv, slots):
    """Whole tiles, every row in exactly one split, within the kernel's
    limits; one wave of blocks when the cache is long enough to fill it,
    and one split when B·Hkv alone fills the card."""
    split_len, n_split = pda.split_plan(B, S, Hkv, slots)
    assert split_len % pda.TILE_ROWS == 0
    assert split_len <= pda.MAX_TILES * pda.TILE_ROWS and n_split <= pda.MAX_SPLITS
    assert (n_split - 1) * split_len < S <= n_split * split_len
    tiles = -(-S // pda.TILE_ROWS)
    if B * Hkv >= slots:
        assert n_split == -(-tiles // pda.MAX_TILES)
    elif tiles >= slots:            # as few tiles a split as one wave allows
        want = max(min(slots // (B * Hkv), -(-tiles // pda.MIN_SPLIT_TILES)),
                   -(-tiles // pda.MAX_TILES))
        assert split_len == pda.TILE_ROWS * -(-tiles // want)
        assert B * Hkv * n_split <= max(slots, B * Hkv * -(-tiles // pda.MAX_TILES))
    if n_split > 1:
        assert split_len >= pda.MIN_SPLIT_TILES * pda.TILE_ROWS


# -- decode attention -------------------------------------------------------------

CASES = [
    # B, S, H, Hkv, Dh, causal, window, kc (tests/test_kernels_decode.py)
    (2, 64, 4, 2, 16, True, None, 16),
    (1, 128, 6, 3, 8, True, 32, 32),
    (3, 32, 4, 4, 32, True, None, 8),
    (1, 64, 8, 1, 16, True, None, 64),     # MQA
]


def _inputs(case, seed=0):
    B, S, H, Hkv, Dh, causal, win, kc = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, Dh), np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh), np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh), np.float32)
    length = S - 5                                    # some unfilled slots
    qp = np.full((B, 1), length - 1, np.int32)
    kp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    kp = np.where(kp < length, kp, -1).astype(np.int32)
    return q, k, v, qp, kp


def _both(q, k, v, qp, kp, *, causal, window, kc, dtype):
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    js = [jnp.asarray(a, jd) for a in (q, k, v)]
    want = decode_attention_pallas(*js, jnp.asarray(qp), jnp.asarray(kp),
                                   causal=causal, window=window, kv_chunk=kc)
    oracle = jattention_ref(*js, jnp.asarray(qp), jnp.asarray(kp),
                            causal=causal, window=window)
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in (q, k, v)]
    got = ops.decode_attention(*ts, torch.from_numpy(qp),
                               torch.from_numpy(np.ascontiguousarray(kp)),
                               causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            np.asarray(oracle.astype(jnp.float32)))


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_pallas_and_oracle(case):
    q, k, v, qp, kp = _inputs(case)
    got, want, oracle = _both(q, k, v, qp, kp, causal=case[5], window=case[6],
                              kc=case[7], dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


def test_decode_ring_style_positions():
    """Out-of-order absolute positions (ring buffer slots) mask correctly."""
    B, S, H, Hkv, Dh = 1, 16, 2, 2, 8
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, 1, H, Dh), np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh), np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh), np.float32)
    kp = ((np.arange(S) + 5) % S + 16)[None].astype(np.int32)
    qp = np.full((B, 1), 31, np.int32)
    got, want, oracle = _both(q, k, v, qp, kp, causal=True, window=8, kc=8,
                              dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_decode_dtypes(dtype, tol):
    case = (2, 64, 4, 2, 16, True, None, 16)
    q, k, v, qp, kp = _inputs(case)
    got, want, _ = _both(q, k, v, qp, kp, causal=True, window=None, kc=16,
                         dtype=dtype)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_decode_fully_masked_row_is_zero():
    q, k, v, qp, kp = _inputs((2, 32, 4, 2, 16, True, None, 8))
    kp = np.full_like(kp, -1)
    got, want, _ = _both(q, k, v, qp, kp, causal=True, window=None, kc=8,
                         dtype=torch.float32)
    assert not got.any() and not want.any()
