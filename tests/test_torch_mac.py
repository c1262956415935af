"""Plain-torch models of the one-launch guard MACs of ``csrc/mpk_guard.cu``
(``mac_update_fused``, ``mac_batch_fused``), held bit for bit against the
JAX reference on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` checks them there);
these models replay their schedules step for step:

* a thread owns lanes 4t..4t+3 of a row, a warp one row, and the W warps of
  a block (``mac_threads``) split its chunk of rows into W runs of
  ceil(chunk / W) rows;
* mac_update: each run's per-lane Horner partial is scaled by P^(rows after
  the run), the warps are summed per lane; a call of one chunk adds h·P^m,
  otherwise each block adds its 128 words into an accumulator as it
  arrives (wrapping atomics) and the last adds h·P^m;
* mac_batch: each thread folds its 4 lanes and scales the word by
  P^(124 - 4t + rows after the run); the block sums its words by warp
  shuffles and then over the warps; a frame of one chunk adds the folded
  seed term, a frame of many is summed by its last block (thread i takes
  the words i, i + 32W, ...).

Each is held to ``mac_update_pallas`` / ``mac_batch_pallas`` (interpret
mode), to ``repro.core.framing.mac_update_np`` / ``mac_batch`` and to the
port's plain versions; one case merges the partials in a shuffled arrival
order, which the sums of words mod 2^32 do not see.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import framing as jframing
from repro.kernels.mpk_guard import mac_batch_pallas, mac_update_pallas

from repro_torch.kernels import mpk_guard as pmg
from repro_torch.kernels.ref import LANES, MAC_INIT, MAC_PRIME, MASK32, mul32

TAG = 0x9E3779B9
FOLD_SUM = sum(pow(MAC_PRIME, e, 1 << 32) for e in range(LANES)) & MASK32


def _pow(e: int) -> int:
    return pow(MAC_PRIME, e, 1 << 32)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _runs(c: int, chunk: int, rows: int, warps: int):
    """The row runs [w0, w1) of the block of chunk c, one a warp."""
    r0, r1 = c * chunk, min(rows, (c + 1) * chunk)
    per_warp = _cdiv(chunk, warps)
    out = []
    for w in range(warps):
        w0 = min(r1, r0 + w * per_warp)
        out.append((w0, min(r1, w0 + per_warp)))
    return out


def _horner(x: torch.Tensor, w0: int, w1: int) -> torch.Tensor:
    """Per-lane Horner over rows [w0, w1) of x (..., rows, 32, 4) int64 →
    (..., 32, 4): a thread's uint4 after its steps."""
    a = torch.zeros(x.shape[:-3] + (32, 4), dtype=torch.int64)
    for r in range(w0, w1):
        a = (mul32(a, MAC_PRIME) + x[..., r, :, :]) & MASK32
    return a


def _merge_order(n: int, order):
    return list(range(n)) if order is None else list(order)


def mac_update_model(h: torch.Tensor, block: torch.Tensor, chunk: int,
                     warps: int = None, order=None) -> torch.Tensor:
    """mac_update_fused's schedule: (128,) uint32 state, (m, 128) uint32
    block → (128,) uint32. ``order`` is the order in which the chunks'
    blocks arrive at the accumulator (chunk order if None)."""
    rows = block.shape[0]
    warps = warps or pmg.mac_threads(rows, chunk) // 32
    x = block.to(torch.int64).reshape(rows, 32, 4)
    nc = max(1, _cdiv(rows, chunk))
    partials = []
    for c in range(nc):
        red = torch.zeros((warps, 32, 4), dtype=torch.int64)   # shared memory
        for w, (w0, w1) in enumerate(_runs(c, chunk, rows, warps)):
            red[w] = mul32(_horner(x, w0, w1), _pow(rows - w1))
        words = red.reshape(warps, LANES)
        s = torch.zeros(LANES, dtype=torch.int64)               # lane_sum
        for w in range(warps):
            s = (s + words[w]) & MASK32
        partials.append(s)
    seed = mul32(h.to(torch.int64), _pow(rows))
    if nc == 1:
        return ((seed + partials[0]) & MASK32).to(torch.uint32)
    acc = torch.zeros(LANES, dtype=torch.int64)    # the workspace's zeroed words
    for c in _merge_order(nc, order):              # atomicAdd as each block arrives
        acc = (acc + partials[c]) & MASK32
    return ((seed + acc) & MASK32).to(torch.uint32)


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """block_sum_warps over (..., warps, 32) int64 words: shuffle-down tree
    in each warp (a lane past the end keeps its own value), then thread 0
    adds the warps' lane-0 words in warp order → (...,)."""
    for o in (16, 8, 4, 2, 1):
        v = (v + torch.cat([v[..., o:], v[..., 32 - o:]], dim=-1)) & MASK32
    s = torch.zeros(v.shape[:-2], dtype=torch.int64)
    for w in range(v.shape[-2]):
        s = (s + v[..., w, 0]) & MASK32
    return s


def mac_batch_model(stack: torch.Tensor, tag: int, chunk: int,
                    warps: int = None, order=None) -> torch.Tensor:
    """mac_batch_fused's schedule: (N, rows, 128) uint32 → (N,) uint32.
    ``order`` permutes the chunk words as a frame's last block reads
    them (chunk order if None)."""
    frames, rows = stack.shape[:2]
    warps = warps or pmg.mac_threads(rows, chunk) // 32
    x = stack.to(torch.int64).reshape(frames, rows, 32, 4)
    nc = max(1, _cdiv(rows, chunk))
    t = torch.arange(32)
    words = []
    for c in range(nc):
        per_thread = torch.zeros((frames, warps, 32), dtype=torch.int64)
        for w, (w0, w1) in enumerate(_runs(c, chunk, rows, warps)):
            a = _horner(x, w0, w1)                               # (N, 32, 4)
            fold = a[..., 0]
            for i in range(1, 4):
                fold = (mul32(fold, MAC_PRIME) + a[..., i]) & MASK32
            scale = torch.tensor([_pow(124 - 4 * int(k) + rows - w1) for k in t])
            per_thread[:, w] = mul32(fold, scale)
        words.append(_block_sum(per_thread))                     # (N,)
    seed = ((MAC_INIT + tag) & MASK32) * _pow(rows) % (1 << 32) * FOLD_SUM % (1 << 32)
    if nc == 1:
        return ((words[0] + seed) & MASK32).to(torch.uint32)
    slots = _merge_order(nc, order)
    threads = 32 * warps
    per_thread = torch.zeros((frames, threads), dtype=torch.int64)
    for i in range(threads):               # thread i: words i, i + 32W, ...
        for j in range(i, nc, threads):
            per_thread[:, i] = (per_thread[:, i] + words[slots[j]]) & MASK32
    s = _block_sum(per_thread.reshape(frames, warps, 32))
    return ((s + seed) & MASK32).to(torch.uint32)


# -- the reference, once per input -------------------------------------------------

def _rng_words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _update_case(rows):
    """(h, block, the Pallas kernel's state, framing.mac_update_np's)."""
    h = _rng_words(rows + 1, (LANES,))
    block = _rng_words(rows + 2, (rows, LANES))
    pallas = np.asarray(mac_update_pallas(jnp.asarray(h), jnp.asarray(block),
                                          rows_per_tile=16))
    return h, block, pallas, jframing.mac_update_np(h, block)


@functools.lru_cache(maxsize=None)
def _batch_case(frames, rows):
    """(stack, the Pallas kernel's MACs or None at 0 rows, framing.mac_batch's)."""
    stack = _rng_words(1000 * frames + rows, (frames, rows, LANES))
    pallas = None
    if rows:        # the Pallas grid has no row tile to run at 0 rows
        pallas = np.asarray(mac_batch_pallas(jnp.asarray(stack), jnp.uint32(TAG),
                                             rows_per_tile=16)).tolist()
    return stack, pallas, jframing.mac_batch(list(stack), TAG)


def _check_update(rows, chunk, warps=None, order=None):
    h, block, pallas, host = _update_case(rows)
    got = mac_update_model(torch.from_numpy(h), torch.from_numpy(block), chunk,
                           warps, order).numpy()
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, host)
    plain = pmg.mac_update_plain(torch.from_numpy(h), torch.from_numpy(block))
    assert np.array_equal(got, plain.numpy())


def _check_batch(frames, rows, chunk, warps=None, order=None):
    stack, pallas, host = _batch_case(frames, rows)
    got = mac_batch_model(torch.from_numpy(stack), TAG, chunk, warps, order).tolist()
    assert got == host
    assert pallas is None or got == pallas
    assert got == pmg.mac_batch_plain(torch.from_numpy(stack), TAG).tolist()


@pytest.mark.parametrize("rows", [0, 1, 63, 64, 65, 300])
@pytest.mark.parametrize("chunk", [1, 64, 128])
def test_mac_update_model_matches_reference(rows, chunk):
    _check_update(rows, chunk)


@pytest.mark.parametrize("rows", [0, 1, 63, 64, 65, 300])
@pytest.mark.parametrize("chunk", [1, 64, 128])
@pytest.mark.parametrize("frames", [1, 3, 16])
def test_mac_batch_model_matches_reference(frames, rows, chunk):
    _check_batch(frames, rows, chunk)


@pytest.mark.parametrize("threads", [128, 256, 512])
def test_models_at_every_block_size(threads):
    """The block sizes the kernels take (128..512 threads), chunks split
    into runs of uneven fill."""
    _check_update(300, 100, threads // 32)
    _check_batch(3, 300, 100, threads // 32)


@pytest.mark.parametrize("rows,chunk,want", [
    (0, 256, 128), (1, 256, 128), (33, 256, 160), (65536, 256, 512), (300, 1, 128),
    (100, 100, 416)])
def test_mac_threads(rows, chunk, want):
    """A warp per 8 rows of a chunk, 4 to 16 warps."""
    assert pmg.mac_threads(rows, chunk, 512) == want


def test_merge_order_does_not_matter():
    """The blocks may arrive in any order: 300 one-row chunks summed in a
    shuffled order give the same bits."""
    order = np.random.default_rng(7).permutation(300)
    _check_update(300, 1, order=order)
    _check_batch(3, 300, 1, order=order)


def test_split_update_is_the_one_shot_mac():
    """mac_init_state → the model over three splits → fold gives the
    one-shot MAC of the reference's host path."""
    _, block, _, _ = _update_case(300)
    h = pmg.mac_init_state_plain(TAG, "cpu")
    for a, b in ((0, 77), (77, 77), (77, 300)):
        h = mac_update_model(h, torch.from_numpy(block[a:b]), 64)
    mac = int(pmg.mac_finalize_plain(h)[0])
    assert mac == jframing._mac_np(block, TAG)
