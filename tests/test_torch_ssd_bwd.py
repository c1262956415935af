"""The SSD backward's plain version (``ssd_scan_bwd_plain``, explicit
formulas) on the CPU: against ``torch.autograd`` through ``ssd_scan_plain``,
against ``jax.grad`` of the reference's sequential oracle ``ssd_ref`` at
mamba2-1.3b's decays (where the reference's chunked SSD is NaN) and of
``ssd_chunked`` at small decays, and ``ops.ssd`` under grad as
``ops.SSDScan`` with no launch counted on the CPU. Inputs are made with
numpy from a seed; shapes are the reference tests' small ones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_ref as jssd_ref
from repro.kernels.ssd_jnp import ssd_chunked as jssd_chunked

from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as pss

NAMES = ("dx", "ddt", "dA_log", "dB", "dC", "dD", "d_init")

CASES = [
    # B, S, H, P, G, N, chunk, init_state, d final state
    (2, 37, 4, 8, 1, 16, 8, True, True),       # S not a chunk multiple
    (1, 64, 6, 4, 2, 8, 16, False, False),     # G > 1, no final-state gradient
    (2, 16, 2, 4, 2, 4, 16, True, False),      # one chunk
    (1, 5, 4, 8, 4, 8, 4, False, True),        # R = 1
    (1, 40, 8, 8, 2, 8, 16, True, True),
]


def _softplus(x):
    return np.log1p(np.exp(x))


def _inputs(case, seed=1, decay="small"):
    """x, dt, A_log, B, C, D, init_state, dy, d final as numpy. ``small``:
    dt ~ 0.1·softplus(N(0,1)), A_log ~ N(0, 0.5²) (the reference tests');
    ``mamba2``: A_log = log(1..H) and dt = softplus(N(0,1) − 2), whose
    chunk decays overflow the reference's chunked SSD."""
    B, S, H, P, G, N, _, init, dfin = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    if decay == "small":
        dt = (_softplus(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
        A_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    else:
        dt = _softplus(rng.standard_normal((B, S, H)) - 2.0).astype(np.float32)
        A_log = np.log(np.arange(1, H + 1, dtype=np.float32))
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if init else None
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    df = rng.standard_normal((B, H, P, N)).astype(np.float32) if dfin else None
    return x, dt, A_log, Bm, Cm, D, s0, dy, df


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _plain(arrs, chunk):
    return pss.ssd_scan_bwd_plain(*map(_t, arrs), chunk=chunk)


def _close(got, want, tol, names=NAMES):
    """Each gradient within ``tol`` of its largest |want| (relative to the
    leaf, as the training tests hold gradients)."""
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w, np.float64)
        g = g.detach().double().numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_matches_autograd_through_the_plain_forward(case):
    """The explicit formulas against autograd through ``ssd_scan_plain`` in
    f32: 1e-5 of each leaf's largest gradient (the two sum in other
    orders, and the formulas carry ddt's chain in f64)."""
    arrs = _inputs(case)
    x, dt, A_log, Bm, Cm, D, s0, dy, df = map(_t, arrs)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A_log, Bm, Cm, D)]
    if s0 is not None:
        ins.append(s0.clone().requires_grad_(True))
    y, fin = pss.ssd_scan_plain(*ins[:6], ins[6] if s0 is not None else None,
                                chunk=case[6])
    loss = (y * dy).sum() + ((fin * df).sum() if df is not None else 0)
    want = list(torch.autograd.grad(loss, ins)) + [None] * (7 - len(ins))
    got = _plain(arrs, case[6])
    assert all(g.dtype == torch.float32 for g in got if g is not None)
    _close(got, [None if w is None else w.numpy() for w in want], 1e-5)


def _jax_grads(fn, arrs):
    """jax.grad of Σ y·dy + Σ final·d final through ``fn``."""
    x, dt, A_log, Bm, Cm, D, s0, dy, df = arrs

    def loss(x, dt, A_log, Bm, Cm, D, s0):
        y, fin = fn(x, dt, A_log, Bm, Cm, D, s0)
        out = jnp.sum(y * dy)
        return out + jnp.sum(fin * df) if df is not None else out

    argnums = tuple(range(7 if s0 is not None else 6))
    g = jax.jit(jax.grad(loss, argnums=argnums))(
        *(jnp.asarray(a) if a is not None else None
          for a in (x, dt, A_log, Bm, Cm, D, s0)))
    return [np.asarray(a) for a in g] + [None] * (7 - len(g))


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_grad_of_chunked_at_small_decays(case):
    """Where the reference's chunked SSD is finite, its autodiff is the
    reference. 1e-5 of each leaf's largest gradient: the two sum in other
    orders, and JAX's prefix sums of dt·A are f32, the port's f64 (seen:
    up to 1.2e-6)."""
    arrs = _inputs(case, seed=2)
    want = _jax_grads(lambda *a: jssd_chunked(*a, chunk=case[6]), arrs)
    _close(_plain(arrs, case[6]), want, 1e-5)


@pytest.mark.parametrize("case", [CASES[0], CASES[4],
                                  (1, 256, 64, 8, 1, 16, 128, True, True)])
def test_matches_jax_grad_of_the_sequential_oracle_at_mamba2_decays(case):
    """mamba2-1.3b's decays (A_log = log(1..H)): the reference's chunked
    SSD and its gradient are NaN once a chunk's summed decay passes ~88 (the
    last case, H 64 and chunk 128, checks that it does), so the reference
    is ``jax.grad`` of the sequential ``ssd_ref``. 1e-5 of each leaf's
    largest gradient: ``ssd_ref`` multiplies the decays step by step in
    f32, the port takes exp of f64 prefix sums (seen: up to 6e-7)."""
    arrs = _inputs(case, seed=3, decay="mamba2")
    if case[6] == 128:
        chunked = _jax_grads(lambda *a: jssd_chunked(*a, chunk=case[6]), arrs)
        assert np.isnan(chunked[1]).any()
    want = _jax_grads(lambda *a: jssd_ref(*a), arrs)
    got = _plain(arrs, case[6])
    assert all(torch.isfinite(g).all() for g in got if g is not None)
    _close(got, want, 1e-5)


def test_ssd_under_grad_runs_ssdscan_with_no_launch_on_the_cpu():
    """ops.ssd under grad is ops.SSDScan: its backward is the plain
    version on the CPU, for every input and the init state, and neither
    the scan nor its backward counts a launch."""
    case = CASES[0]
    arrs = _inputs(case, seed=4)
    x, dt, A_log, Bm, Cm, D, s0, dy, df = map(_t, arrs)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A_log, Bm, Cm, D, s0)]
    ops.LAUNCHES.reset()
    y, fin = ops.ssd(*ins, chunk=case[6])
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    got = torch.autograd.grad((y * dy).sum() + (fin * df).sum(), ins)
    want = _plain(arrs, case[6])
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    n = ops.LAUNCHES.snapshot()
    assert n["ssd_scan"] == 0 and n["ssd_scan_bwd"] == 0


def test_final_state_without_gradient_is_none_to_the_backward():
    """Training drops the final state: the backward gets no gradient for it
    and gives the same dx as an explicit zero gradient."""
    case = CASES[2]
    arrs = _inputs(case, seed=5)
    x, dt, A_log, Bm, Cm, D, s0, dy, _ = map(_t, arrs)
    xr = x.clone().requires_grad_(True)
    y, _ = ops.ssd(xr, dt, A_log, Bm, Cm, D, s0, chunk=case[6])
    (gx,) = torch.autograd.grad((y * dy).sum(), (xr,))
    zero = pss.ssd_scan_bwd_plain(x, dt, A_log, Bm, Cm, D, s0, dy,
                                  torch.zeros_like(s0), chunk=case[6])
    assert torch.equal(gx, zero[0])


def test_bwd_wrapper_refuses_cpu_tensors():
    """The CUDA backward never falls back to the plain version."""
    arrs = _inputs(CASES[0])
    with pytest.raises(ValueError, match="CUDA tensors required"):
        pss.ssd_scan_bwd_cuda(*map(_t, arrs), chunk=CASES[0][6])
    with pytest.raises(ValueError, match="CUDA tensors required"):
        pss.bwd_launches(*map(_t, arrs), chunk=CASES[0][6])


# ---------------------------------------------------------------------------
# The bf16 chunk kernel by tiles of heads: its arithmetic as a design model,
# and its launch plan
# ---------------------------------------------------------------------------

def _bf(t):
    """t rounded to bf16, as f32."""
    return t.to(torch.bfloat16).float()


def _hilo(t):
    """An f32 operand as the kernel feeds it to the tensor cores: a bf16 hi
    + lo pair (about 16 bits of mantissa)."""
    hi = _bf(t)
    return hi + _bf(t - hi)


def _tile_model(x, dt, A_log, B, C, dy, init, dfinal, chunk, ht):
    """dB and dC as ``ssd_bwd_tile_mma`` forms them, in plain torch: x, B,
    C, dy bf16-valued; per chunk and group, the heads in tiles of ``ht`` (the
    last one short); per tile Σ_h M^h (M^h_ij = e_ij·dt_j·(dy_i·x_j), masked
    to i ≥ j, f32, in head order) rounded to hi + lo once, then ·C (dB) and
    ·B (dC); the carry w_j·x_jᵀ·dS and inter exp(cum_i)·dy_i·S_in per head
    with dS and S_in as hi + lo; f32 sums; the tiles' partials summed in
    order (the finish pass). S_in and dS come from the f64 walks of
    ``ssd_scan_bwd_plain``, rounded to f32 as the kernels keep them."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q
    xb = pss._pad_seq(x, pad).reshape(Bb, nc, Q, G, R, P)
    dyb = pss._pad_seq(dy, pad).reshape(Bb, nc, Q, G, R, P)
    dtb = pss._pad_seq(dt, pad).reshape(Bb, nc, Q, G, R)
    Bc = pss._pad_seq(B, pad).reshape(Bb, nc, Q, G, N)
    Cc = pss._pad_seq(C, pad).reshape(Bb, nc, Q, G, N)
    A = -torch.exp(A_log).reshape(G, R)
    cum = torch.cumsum((dtb * A).double(), dim=2)
    seg = cum[:, :, -1:]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    diff = (cum[:, :, :, None] - cum[:, :, None]).float()          # [i, j]
    dec = torch.exp(torch.where(tri[None, None, :, :, None, None], diff,
                                torch.tensor(float("-inf"))))
    w = (torch.exp(seg - cum) * dtb).float()                       # (B,nc,Q,G,R)
    e_cum = torch.exp(cum).float()
    # the chunk states S_in and the gradients dS of the states leaving chunks
    s_c = torch.einsum("bcjgrp,bcjgn->bcgrpn", (torch.exp(seg - cum) * dtb)[..., None]
                       * xb.double(), Bc.double())
    ds_c = torch.einsum("bcigrp,bcign->bcgrpn", torch.exp(cum)[..., None] * dyb.double(),
                        Cc.double())
    decay = torch.exp(seg[:, :, 0])
    state = (torch.zeros((Bb, G, R, P, N), dtype=torch.float64) if init is None
             else init.double().reshape(Bb, G, R, P, N))
    back = (torch.zeros((Bb, G, R, P, N), dtype=torch.float64) if dfinal is None
            else dfinal.double().reshape(Bb, G, R, P, N))
    s_in, ds_out = [None] * nc, [None] * nc
    for c in range(nc):
        s_in[c] = state
        state = decay[:, c, :, :, None, None] * state + s_c[:, c]
    for c in reversed(range(nc)):
        ds_out[c] = back
        back = decay[:, c, :, :, None, None] * back + ds_c[:, c]
    s_in, ds_out = torch.stack(s_in, 1).float(), torch.stack(ds_out, 1).float()

    dyx = torch.einsum("bcigrp,bcjgrp->bcijgr", dyb, xb)
    M = dec * dtb[:, :, None] * dyx                                # (B,nc,Q,Q,G,R)
    dB = torch.zeros((Bb, nc, Q, G, N))
    dC = torch.zeros((Bb, nc, Q, G, N))
    for t0 in range(0, R, ht):
        heads = range(t0, min(R, t0 + ht))
        msum = torch.zeros((Bb, nc, Q, Q, G))
        for r in heads:
            msum = msum + M[..., r]
        part_b = torch.zeros((Bb, nc, Q, G, N))
        part_c = torch.zeros((Bb, nc, Q, G, N))
        for r in heads:
            part_b = part_b + w[..., r, None] * torch.einsum(
                "bcjgp,bcgpn->bcjgn", xb[..., r, :], _hilo(ds_out[:, :, :, r]))
            part_c = part_c + e_cum[..., r, None] * torch.einsum(
                "bcigp,bcgpn->bcign", dyb[..., r, :], _hilo(s_in[:, :, :, r]))
        mh = _hilo(msum)
        part_b = part_b + torch.einsum("bcijg,bcign->bcjgn", mh, Cc)
        part_c = part_c + torch.einsum("bcijg,bcjgn->bcign", mh, Bc)
        dB, dC = dB + part_b, dC + part_c
    return (dB.reshape(Bb, nc * Q, G, N)[:, :S], dC.reshape(Bb, nc * Q, G, N)[:, :S])


TILE_CASES = [
    # B, S, H, P, G, N, chunk, init_state, d final state; heads per tile
    ((1, 48, 8, 8, 1, 16, 16, False, False), 8),    # G 1, one tile of 8 heads
    ((2, 40, 8, 8, 2, 8, 16, True, True), 4),       # G > 1, a tile per group
    ((1, 40, 12, 8, 1, 8, 16, False, True), 8),     # H/G 12: tiles of 8 and 4
    ((1, 33, 12, 4, 3, 8, 8, True, False), 3),      # G 3, ragged S
    ((1, 64, 10, 8, 2, 16, 32, False, False), 2),   # H/G 5: tiles of 2, 2 and 1
]


def _bf16_inputs(case, seed, decay):
    """The inputs as the bf16 kernel sees them: x, B, C, dy bf16-valued."""
    x, dt, A_log, Bm, Cm, D, s0, dy, df = _inputs(case, seed=seed, decay=decay)
    x, Bm, Cm, dy = (_bf(torch.from_numpy(a)).numpy() for a in (x, Bm, Cm, dy))
    return x, dt, A_log, Bm, Cm, D, s0, dy, df


@pytest.mark.parametrize("case,ht", TILE_CASES)
def test_tile_model_matches_the_plain_backward(case, ht):
    """The head-tile arithmetic (Σ M over a tile, rounded to hi + lo once,
    then ·C and ·B; dS and S_in as hi + lo) against ``ssd_scan_bwd_plain``
    on the same bf16-valued inputs at mamba2's decays, for dB and dC: 2e-2 of
    each leaf's largest gradient, the kernels' bf16 tolerance."""
    arrs = _bf16_inputs(case, seed=6, decay="mamba2")
    x, dt, A_log, Bm, Cm, D, s0, dy, df = map(_t, arrs)
    dB, dC = _tile_model(x, dt, A_log, Bm, Cm, dy, s0, df, case[6], ht)
    want = _plain(arrs, case[6])
    _close([dB, dC], [want[3].numpy(), want[4].numpy()], 2e-2, names=("dB", "dC"))


@pytest.mark.parametrize("case,ht", TILE_CASES)
def test_tile_model_matches_jax_grad_of_the_sequential_oracle(case, ht):
    """The same model against ``jax.grad`` of the reference's sequential
    ``ssd_ref`` at mamba2's decays (A_log = log(1..H)), 2e-2 of each leaf's
    largest gradient."""
    arrs = _bf16_inputs(case, seed=7, decay="mamba2")
    x, dt, A_log, Bm, Cm, D, s0, dy, df = map(_t, arrs)
    dB, dC = _tile_model(x, dt, A_log, Bm, Cm, dy, s0, df, case[6], ht)
    want = _jax_grads(lambda *a: jssd_ref(*a), arrs)
    _close([dB, dC], [want[3], want[4]], 2e-2, names=("dB", "dC"))


def test_tile_model_with_one_head_a_tile_is_the_per_head_sum():
    """With one head a tile, Σ M is each head's M: the model's dB and dC
    then sum per-head partials, as the earlier kernel and its finish pass
    did; tiles of 8 agree with it to 2e-2 of the largest gradient."""
    case = TILE_CASES[2][0]
    arrs = _bf16_inputs(case, seed=8, decay="mamba2")
    x, dt, A_log, Bm, Cm, D, s0, dy, df = map(_t, arrs)
    one = _tile_model(x, dt, A_log, Bm, Cm, dy, s0, df, case[6], 1)
    eight = _tile_model(x, dt, A_log, Bm, Cm, dy, s0, df, case[6], 8)
    _close(list(eight), [t.numpy() for t in one], 2e-2, names=("dB", "dC"))


@pytest.mark.parametrize("Bb,S,H,G,chunk,sms,want", [
    (2, 2048, 64, 1, 128, 132, 8),     # mamba2-1.3b's microbatch: 256 blocks, two waves
    (4, 2048, 64, 1, 128, 132, 8),
    (1, 2048, 80, 1, 128, 132, 5),     # zamba2-2.7b's 80 heads: 256 blocks of 5
    (1, 200, 12, 1, 32, 132, 1),       # 7 chunks: one head a block fills more SMs
    (2, 1000, 16, 4, 128, 132, 2),
    (1, 64, 8, 8, 64, 132, 1),         # one head a group
    (2, 400, 24, 1, 32, 132, 5),       # tiles of 5, 5, 5, 5 and 4
    (1, 2048, 12, 4, 128, 132, 2),     # groups of 3 heads: tiles of 2 and 1
])
def test_bwd_heads_per_tile(Bb, S, H, G, chunk, sms, want):
    """The chunk kernel's heads per block: the fewest waves x (HT + 1) of
    one-block-per-SM blocks, ties to the larger HT, HT <= min(8, H / G);
    some shapes leave a group's last tile short (24 heads in tiles of 5)."""
    ht = pss.bwd_heads_per_tile(Bb, S, H, G, chunk, sms)
    assert ht == want
    R = H // G
    assert 1 <= ht <= min(pss.BWD_MAX_HEADS_PER_TILE, R)
    blocks = -(-S // chunk) * Bb * G

    def cost(t):
        return -(-blocks * pss.bwd_partials_per_group(H, G, t) // sms) * (t + 1)

    assert all(cost(ht) < cost(t) or (cost(ht) == cost(t) and ht >= t)
               for t in range(1, min(8, R) + 1))


@pytest.mark.parametrize("H,G,ht,want", [(64, 1, 8, 8), (80, 1, 5, 16), (12, 1, 8, 2),
                                         (16, 4, 4, 1), (10, 2, 2, 3), (8, 1, 1, 8)])
def test_bwd_partials_per_group(H, G, ht, want):
    """dB / dC partials a group has: one per tile of heads, the last tile
    short; the scratch is (B, S, G x that, N), H / HT times smaller than a
    partial per head when HT divides H / G."""
    assert pss.bwd_partials_per_group(H, G, ht) == want
    assert want * ht >= H // G > (want - 1) * ht


def test_per_head_backward_refuses_f32_and_cpu():
    """The earlier per-head kernel exists in bf16 only, on the card only;
    neither falls back to the plain version."""
    arrs = _inputs(CASES[0])
    with pytest.raises(ValueError, match="bf16 x required"):
        pss._ssd_scan_bwd_per_head(*map(_t, arrs), chunk=CASES[0][6])
    x, dt, A_log, Bm, Cm, D, s0, dy, df = map(_t, arrs)
    bf = [t.to(torch.bfloat16) for t in (x, Bm, Cm, dy)]
    with pytest.raises(ValueError, match="CUDA tensors required"):
        pss._ssd_scan_bwd_per_head(bf[0], dt, A_log, bf[1], bf[2], D, s0, bf[3], df,
                                   chunk=CASES[0][6])
    with pytest.raises(ValueError, match="CUDA tensors required"):
        pss.bwd_launches(bf[0], dt, A_log, bf[1], bf[2], D, s0, bf[3], df,
                         chunk=CASES[0][6], per_head=True)
