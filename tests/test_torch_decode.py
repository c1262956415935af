"""Plain-torch models of the one-launch designs of ``csrc/decode_attention.cu``
(``decode_fused_f32`` / ``decode_fused_bf16``) and ``csrc/mpk_guard.cu``
(``guard_copy_fused``), held against the JAX reference on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` checks them there);
these models replay their schedules step for step, so the order of the sums
that the kernels rely on is tested here:

* decode attention: the splits of ``split_plan``, 64-row tiles with fully
  masked tiles skipped, a per row-group online softmax in the log2 domain
  (rescaled only when a head's max grows), the row groups merged per split,
  then the splits merged in split order in one pass; against
  ``decode_attention_pallas`` (interpret mode) and ``attention_ref`` at 2e-5
  in f32 and 2e-2 in bf16;
* guard_copy: 4-lane groups per thread, a warp's quarter of each chunk,
  per-chunk folded words summed in chunk order plus the seed term
  h0·P^n·Σ P^e; bit for bit against the JAX ``guard_copy`` (Pallas,
  interpret mode) and ``core.framing._mac_np``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import framing as jframing
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.ref import attention_ref as jattention_ref

from repro_torch.kernels import decode_attention as pda
from repro_torch.kernels.ref import LANES, MAC_INIT, MAC_PRIME, MASK32, mul32

NEG_BIG = -1e30
THREADS = 128


# -- decode attention --------------------------------------------------------------

def _valid(kp, qp, causal, window):
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & ((qp - kp) < window)
    return ok


def decode_model(q, k, v, qp, kp, *, causal=True, window=None, slots=pda.TARGET_BLOCKS):
    """The kernel's schedule in plain torch: → (out, n_split). The plan is
    ``split_plan``'s for ``slots``.
    Each split walks its 64-row tiles, skipping the fully masked ones; a row
    group keeps an online softmax per head (log2 domain, rescaled only when
    the max grows) over its rows of every tile, in batches. f32 (CUDA
    cores): row group rg of RG = 128 / chunks-per-row holds rows rg, rg + RG,
    ... in batches of RB. bf16 (mma.sync): warp w holds rows 16w..16w+15 in
    one batch, and P enters P·V rounded to bf16. The groups merge per split,
    then the splits in order in one pass."""
    B, _, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    T = pda.TILE_ROWS
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        RG, RPT, RB = 4, 16, 16
        order = torch.arange(T).reshape(RG, RPT).T                   # [it, w] = 16w + it
    else:
        ncp = max(2, 1 << math.ceil(math.log2(Dh // 4)))
        RG = THREADS // ncp
        RPT = T // RG
        RB = (2 if RPT >= 2 else 1) if (g > 4 or RPT < 4) else 4
        order = torch.arange(T).reshape(RPT, RG)                      # [it, rg] = rg + RG·it
    split_len, n_split = pda.split_plan(B, S, Hkv, slots)
    scale2 = Dh ** -0.5 * math.log2(math.e)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for b in range(B):
        valid_all = _valid(kp[b], int(qp[b, 0]), causal, window)
        for h in range(Hkv):
            qh = q[b, 0, h * g:(h + 1) * g].float()                   # (g, Dh)
            parts = []
            for sp in range(n_split):
                s0, s1 = sp * split_len, min(S, (sp + 1) * split_len)
                m = torch.full((RG, g), NEG_BIG)
                l = torch.zeros((RG, g))
                acc = torch.zeros((RG, g, Dh))
                for t0 in range(s0, s1, T):
                    rows = torch.arange(t0, t0 + T)
                    inside = rows < s1
                    ok = torch.zeros(T, dtype=torch.bool)
                    ok[inside] = valid_all[rows[inside]]
                    if not ok.any():
                        continue                                      # never loaded
                    kt = torch.zeros((T, Dh))
                    vt = torch.zeros((T, Dh))
                    kt[inside] = k[b, rows[inside], h].float()
                    vt[inside] = v[b, rows[inside], h].float()
                    kt, vt, ok = kt[order], vt[order], ok[order]      # (RPT, RG, ...)
                    for r0 in range(0, RPT, RB):
                        sc = torch.einsum("irc,gc->irg", kt[r0:r0 + RB], qh)
                        sc = torch.where(ok[r0:r0 + RB, :, None], sc * scale2,
                                         torch.tensor(-math.inf))
                        mx = sc.amax(0)                               # (RG, g)
                        grow = mx > m
                        corr = torch.where(grow, torch.exp2(m - mx), torch.ones(()))
                        l = l * corr
                        acc = acc * corr[..., None]
                        m = torch.where(grow, mx, m)
                        p = torch.where(ok[r0:r0 + RB, :, None], torch.exp2(sc - m),
                                        torch.zeros(()))              # (RB, RG, g)
                        l = l + p.sum(0)
                        pv = p.to(torch.bfloat16).float() if bf16 else p
                        acc = acc + torch.einsum("irg,ird->rgd", pv, vt[r0:r0 + RB])
                M = m.amax(0)                                         # (g,)
                w = torch.exp2(m - M)
                parts.append((M, (l * w).sum(0), (acc * w[..., None]).sum(0)))
            if n_split == 1:
                M, L, A = parts[0]
            else:                       # the last block: splits in order, one pass
                M = torch.full((g,), NEG_BIG)
                L = torch.zeros(g)
                A = torch.zeros((g, Dh))
                for Ms, Ls, As in parts:
                    grow = Ms > M
                    corr = torch.where(grow, torch.exp2(M - Ms), torch.ones(()))
                    L, A, M = L * corr, A * corr[:, None], torch.where(grow, Ms, M)
                    w = torch.exp2(Ms - M)
                    L = L + Ls * w
                    A = A + As * w[:, None]
            out[b, 0, h * g:(h + 1) * g] = A / torch.clamp(L, min=1e-30)[:, None]
    return out.to(q.dtype), n_split


CASES = [
    # B, S, H, Hkv, Dh, causal, window, kc (tests/test_kernels_decode.py)
    (2, 64, 4, 2, 16, True, None, 16),
    (1, 128, 6, 3, 8, True, 32, 32),
    (3, 32, 4, 4, 32, True, None, 8),
    (1, 64, 8, 1, 16, True, None, 64),     # MQA
]


def _inputs(B, S, H, Hkv, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, Dh), np.float32),
            rng.standard_normal((B, S, Hkv, Dh), np.float32),
            rng.standard_normal((B, S, Hkv, Dh), np.float32))


def _against_reference(q, k, v, qp, kp, *, causal, window, slots, kc=None):
    """The model against attention_ref (and the Pallas kernel when ``kc``
    divides S) in f32 → n_split."""
    got, n_split = decode_model(*(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in (q, k, v, qp, kp)),
                                causal=causal, window=window, slots=slots)
    js = [jnp.asarray(a) for a in (q, k, v, qp, kp)]
    oracle = np.asarray(jattention_ref(*js, causal=causal, window=window))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)
    if kc is not None:
        want = np.asarray(decode_attention_pallas(*js, causal=causal, window=window,
                                                  kv_chunk=kc))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    return n_split


@pytest.mark.parametrize("case", CASES)
def test_decode_model_matches_pallas_and_oracle(case):
    """The reference test's cases (one split each)."""
    B, S, H, Hkv, Dh, causal, win, kc = case
    q, k, v = _inputs(B, S, H, Hkv, Dh)
    length = S - 5
    qp = np.full((B, 1), length - 1, np.int32)
    kp = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    kp = np.where(kp < length, kp, -1).astype(np.int32)
    assert _against_reference(q, k, v, qp, kp, causal=causal, window=win,
                              slots=pda.TARGET_BLOCKS, kc=kc) == 1


@pytest.mark.parametrize("S,window,slots", [(16, 8, pda.TARGET_BLOCKS),
                                            (300, 64, pda.TARGET_BLOCKS),
                                            (2100, 256, pda.TARGET_BLOCKS),
                                            (2100, None, 4), (2100, None, pda.TARGET_BLOCKS)])
def test_decode_model_ring_positions(S, window, slots):
    """Slots hold absolute positions out of order (a ring cache), with and
    without a window; one split and several."""
    B, H, Hkv, Dh = 2, 4, 2, 16
    q, k, v = _inputs(B, S, H, Hkv, Dh, seed=1)
    kp = np.stack([(np.arange(S) + 5 + 7 * b) % S + 5000 for b in range(B)]
                  ).astype(np.int32)
    qp = np.full((B, 1), 5000 + S - 1, np.int32)
    kc = 4 if S % 4 == 0 else None
    n_split = _against_reference(q, k, v, qp, kp, causal=True, window=window,
                                 slots=slots, kc=kc)
    assert n_split == pda.split_plan(B, S, Hkv, slots)[1]
    assert (n_split > 1) == (S > 1024 and slots > B * Hkv)


def test_decode_model_masked_splits_and_rows():
    """Splits that are entirely masked (short sequences in a long cache) and
    a row with no valid slot at all: its output is 0, as the Pallas kernel
    gives it."""
    B, S, H, Hkv, Dh = 3, 2600, 4, 2, 16
    q, k, v = _inputs(B, S, H, Hkv, Dh, seed=2)
    lens = np.array([70, 0, 2600])
    ar = np.arange(S)
    kp = np.where(ar[None] < lens[:, None], ar[None], -1).astype(np.int32)
    qp = np.maximum(lens - 1, 0)[:, None].astype(np.int32)
    split_len, n_split = pda.split_plan(B, S, Hkv)
    assert n_split > 2 and split_len < S - 70           # splits past row 70 are empty
    _against_reference(q, k, v, qp, kp, causal=True, window=None,
                       slots=pda.TARGET_BLOCKS, kc=8)
    got, _ = decode_model(*(torch.from_numpy(a) for a in (q, k, v, qp, kp)))
    assert not got[1].any()


@pytest.mark.parametrize("S", [200, 2100])
def test_decode_model_bf16(S):
    """The bf16 kernel's schedule (a warp's 16 rows a batch, P rounded to
    bf16 for P·V) on bf16 inputs, one split and several, against
    attention_ref at 2e-2."""
    B, H, Hkv, Dh = 2, 8, 2, 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(B, S, H, Hkv, Dh, 3))
    kp = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    kp[1, 150:] = -1
    qp = torch.tensor([[S - 1], [149]], dtype=torch.int32)
    got, n_split = decode_model(q, k, v, qp, kp)
    js = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    want = jattention_ref(*js, jnp.asarray(qp.numpy()), jnp.asarray(kp.numpy()))
    assert n_split == (1 if S <= 1024 else 3)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


# -- guard_copy ---------------------------------------------------------------------

def _pow(e: int) -> int:
    return pow(MAC_PRIME, e, 1 << 32)


def guard_model(payload: torch.Tensor, tag: int, expected: int, chunk: int):
    """guard_copy_fused's schedule on an (n, 128) uint32 payload → (copy,
    mac, ok). Thread t of a warp owns lanes 4t..4t+3; warp w of a block
    walks rows [r0 + w·q, r0 + (w+1)·q) of its chunk (q = ceil(chunk / 4))."""
    n = payload.shape[0]
    x = payload.to(torch.int64).reshape(n, 32, 4)
    n_chunks = max(1, -(-n // chunk))
    per_warp = -(-chunk // 4)
    words = []
    for c in range(n_chunks):
        r0, r1 = c * chunk, min(n, (c + 1) * chunk)
        block = torch.zeros(32, dtype=torch.int64)
        for w in range(4):
            w0 = min(r1, r0 + w * per_warp)
            w1 = min(r1, w0 + per_warp)
            a = torch.zeros((32, 4), dtype=torch.int64)
            for r in range(w0, w1):                        # Horner per lane
                a = (mul32(a, MAC_PRIME) + x[r]) & MASK32
            fold = a[:, 0]                                 # lanes 4t..4t+3
            for i in range(1, 4):
                fold = (mul32(fold, MAC_PRIME) + a[:, i]) & MASK32
            scale = torch.tensor([_pow(124 - 4 * t + n - w1) for t in range(32)])
            block = (block + mul32(fold, scale)) & MASK32
        words.append(int(block.sum()) & MASK32)            # block_sum
    fold_sum = sum(_pow(e) for e in range(LANES)) & MASK32
    mac = ((MAC_INIT + tag) * _pow(n) * fold_sum) & MASK32
    for wd in words:                                       # chunk order
        mac = (mac + wd) & MASK32
    return payload.clone(), mac, int(mac == (expected & MASK32))


@pytest.mark.parametrize("rows", [0, 1, 63, 64, 65, 300])
@pytest.mark.parametrize("chunk", [1, 64, 128])
def test_guard_model_matches_reference(rows, chunk):
    rng = np.random.default_rng(rows * 7 + chunk)
    p = rng.integers(0, 2 ** 32, (rows, LANES), dtype=np.uint32)
    tag = 0x9E3779B9
    want = jframing._mac_np(p, tag)
    copy, mac, ok = guard_model(torch.from_numpy(p), tag, want, chunk)
    assert np.array_equal(copy.numpy(), p)
    assert (mac, ok) == (want, 1)
    assert guard_model(torch.from_numpy(p), tag ^ 1, want, chunk)[2] == 0
    if rows:
        out_j, mac_j, ok_j = jops.guard_copy(jnp.asarray(p), jnp.uint32(tag),
                                             jnp.uint32(want), rows_per_tile=64)
        assert np.array_equal(np.asarray(out_j), p)
        assert [mac] == np.asarray(mac_j).tolist() and np.asarray(ok_j).tolist() == [1]
        p[rows // 2, rows % LANES] ^= 1
        assert guard_model(torch.from_numpy(p), tag, want, chunk)[2] == 0
