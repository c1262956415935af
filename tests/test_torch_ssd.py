"""The port's Mamba2 SSD on the CPU (its plain version) against the JAX
reference: ``ssd_scan_pallas`` (interpret mode, through
``repro.kernels.ops.ssd`` where the length needs padding), ``ssd_chunked``
and the sequential oracle ``ssd_ref``, on the cases of
``tests/test_kernels_ssd.py`` at 1e-4, with state continuation and the
decode chain. A chunk whose summed decay passes ~88 makes the reference's
chunked SSD return NaN; the port's stays finite and equals ``ssd_ref``.
Inputs are made with numpy from a seed and handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import ssd as jssd
from repro.kernels.ref import ssd_ref as jssd_ref
from repro.kernels.ssd_jnp import ssd_chunked as jssd_chunked
from repro.kernels.ssd_jnp import ssd_decode_step as jssd_decode_step

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as pss

TOL = 1e-4

CASES = [
    # B, S, H, P, G, N, chunk
    (2, 37, 4, 8, 1, 16, 8),
    (1, 64, 6, 4, 2, 8, 16),
    (2, 16, 2, 4, 2, 4, 16),
    (1, 5, 4, 8, 4, 8, 4),
]


def _softplus(x):
    return np.log1p(np.exp(x))


def _inputs(case, seed=1):
    B, S, H, P, G, N, Q = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (_softplus(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    A_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return (x, dt, A_log, Bm, Cm, D), Q


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_matches_pallas_chunked_and_ref(case):
    arrs, Q = _inputs(case)
    yp, sp = jssd(*_j(arrs), chunk=Q, impl="pallas")
    yc, sc = jssd_chunked(*_j(arrs), chunk=Q)
    yr, sr = jssd_ref(*_j(arrs))
    y, s = ops.ssd(*_t(arrs), chunk=Q)
    assert y.shape == tuple(case[:4]) and s.dtype == torch.float32
    for want_y, want_s in ((yp, sp), (yc, sc), (yr, sr)):
        _close(y.numpy(), want_y)
        _close(s.numpy(), want_s)


@pytest.mark.parametrize("case", CASES)
def test_oracle_matches_reference_oracle(case):
    arrs, _ = _inputs(case, seed=2)
    y, s = ref.ssd_ref(*_t(arrs))
    yr, sr = jssd_ref(*_j(arrs))
    _close(y.numpy(), yr)
    _close(s.numpy(), sr)


def test_state_continuation():
    """Splitting a sequence and carrying the state == processing it whole."""
    arrs, Q = _inputs((2, 32, 4, 8, 1, 16, 8))
    x, dt, A_log, Bm, Cm, D = _t(arrs)
    yr, sr = jssd_ref(*_j(arrs))
    h = 16
    y1, s1 = ops.ssd(x[:, :h], dt[:, :h], A_log, Bm[:, :h], Cm[:, :h], D, chunk=Q)
    y2, s2 = ops.ssd(x[:, h:], dt[:, h:], A_log, Bm[:, h:], Cm[:, h:], D,
                     init_state=s1, chunk=Q)
    _close(torch.cat([y1, y2], 1).numpy(), yr)
    _close(s2.numpy(), sr)


def test_decode_chain_matches_ref():
    arrs, _ = _inputs((1, 12, 4, 8, 2, 8, 4))
    x, dt, A_log, Bm, Cm, D = _t(arrs)
    yr, sr = jssd_ref(*_j(arrs))
    B, S, H, P = x.shape
    st = torch.zeros((B, H, P, Bm.shape[-1]))
    jst = jnp.zeros((B, H, P, Bm.shape[-1]))
    ys = []
    for t in range(S):
        y_t, st = pss.ssd_decode_step(x[:, t], dt[:, t], A_log, Bm[:, t],
                                      Cm[:, t], D, st)
        jy, jst = jssd_decode_step(*_j((arrs[0][:, t], arrs[1][:, t], arrs[2],
                                        arrs[3][:, t], arrs[4][:, t], arrs[5])),
                                   jst)
        _close(y_t.numpy(), jy)
        ys.append(y_t)
    _close(torch.stack(ys, 1).numpy(), yr)
    _close(st.numpy(), sr)


def test_bf16_matches_chunked():
    arrs, Q = _inputs((2, 40, 4, 8, 2, 16, 16), seed=3)
    x, dt, A_log, Bm, Cm, D = _t(arrs)
    jx, jdt, jA, jB, jC, jD = _j(arrs)
    yc, sc = jssd_chunked(jx.astype(jnp.bfloat16), jdt, jA, jB.astype(jnp.bfloat16),
                          jC.astype(jnp.bfloat16), jD, chunk=Q)
    y, s = ops.ssd(x.bfloat16(), dt, A_log, Bm.bfloat16(), Cm.bfloat16(), D,
                   chunk=Q)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yc.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(sc), rtol=2e-2, atol=2e-2)


def test_large_chunk_decay_is_finite_where_the_reference_is_nan():
    """mamba2-1.3b's head count and chunk with its init's decays:
    A_log = log(1..64), dt = softplus(N(0,1) − 4), Q = 128. Head 64's chunk
    decay Σ dt·|A| is ~200; exp over the whole Q×Q square overflows in the
    reference's chunked SSD (NaN), while the masked exponent stays finite
    and equals the sequential oracle."""
    B, S, H, P, G, N, Q = 1, 256, 64, 8, 1, 16, 128
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((B, S, H)) - 4.0).astype(np.float32)
    A_log = np.log(np.arange(1, H + 1, dtype=np.float32))
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    D = np.ones(H, np.float32)
    arrs = (x, dt, A_log, Bm, Cm, D)
    assert (dt[0, :Q, -1] * H).sum() > 88.0
    yc, _ = jssd_chunked(*_j(arrs), chunk=Q)
    assert np.isnan(np.asarray(yc)).any()
    yr, sr = jssd_ref(*_j(arrs))
    assert np.isfinite(np.asarray(yr)).all()
    y, s = ops.ssd(*_t(arrs), chunk=Q)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close(y.numpy(), yr)
    _close(s.numpy(), sr)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    arrs, Q = _inputs(CASES[0])
    ops.LAUNCHES.reset()
    y, s = ops.ssd(*_t(arrs), chunk=Q)
    y2, s2 = pss.ssd_scan_plain(*_t(arrs), chunk=Q)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert ops.LAUNCHES.snapshot()["ssd_scan"] == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back to the plain version."""
    arrs, Q = _inputs(CASES[0])
    with pytest.raises(ValueError, match="CUDA tensors required"):
        pss.ssd_scan_cuda(*_t(arrs), chunk=Q)


def _hi_lo(t):
    """t as the sum of its bf16 rounding and the bf16 rounding of the rest."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


def _bf16_design(x, dt, A_log, B, C, D, init_state=None, *, chunk=128):
    """The bf16 kernels' arithmetic in plain torch: x, B, C bf16 operands;
    cum in f64; w⊙x, att and S_in each entering their products as a bf16
    hi + lo pair; f32 accumulation; y rounded to bf16 once."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    Q = chunk
    pad = (-S) % Q
    xb = pss._pad_seq(x.float(), pad)
    nc = xb.shape[1] // Q
    xb = xb.reshape(Bb, nc, Q, G, R, P)
    dtb = pss._pad_seq(dt.float(), pad).reshape(Bb, nc, Q, G, R)
    Bc = pss._pad_seq(B.float(), pad).reshape(Bb, nc, Q, G, N)
    Cc = pss._pad_seq(C.float(), pad).reshape(Bb, nc, Q, G, N)
    A = -torch.exp(A_log.float()).reshape(G, R)
    cum = torch.cumsum((dtb * A).double(), dim=2)
    seg = cum[:, :, -1:]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None, None]
    diff = (cum[:, :, :, None] - cum[:, :, None]).float()
    dec = torch.exp(torch.where(tri, diff, torch.tensor(float("-inf"))))
    cb = torch.einsum("bcqgn,bcjgn->bcqjg", Cc, Bc)
    att = _hi_lo(cb[..., None] * dec * dtb[:, :, None])
    y = torch.einsum("bcqjgr,bcjgrp->bcqgrp", att, xb)
    wx = _hi_lo(torch.exp((seg - cum).float())[..., None] * dtb[..., None] * xb)
    s_c = torch.einsum("bcjgrp,bcjgn->bcgrpn", wx, Bc)
    state = (torch.zeros((Bb, G, R, P, N)) if init_state is None
             else init_state.float().reshape(Bb, G, R, P, N))
    decay = torch.exp(seg[:, :, 0].float())
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = decay[:, c, :, :, None, None] * state + s_c[:, c]
    s_in = _hi_lo(torch.stack(s_in, dim=1))
    y = y + torch.einsum("bcqgn,bcgrpn->bcqgrp", Cc, s_in) \
        * torch.exp(cum.float())[..., None]
    y = y.reshape(Bb, nc * Q, H, P)[:, :S] + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state.reshape(Bb, H, P, N)


@pytest.mark.parametrize("S,init", [(256, False), (256, True), (200, True)])
def test_bf16_design_within_tolerance_of_reference(S, init):
    """At mamba2-1.3b's head widths (H 64, P 64, N 128, chunk 128, G 1) and
    its init's decays, the tensor-core kernels' rounding points stay within
    the bf16 tolerance, 2e-2·(1 + |y|), of the JAX sequential oracle."""
    H, P, G, N = 64, 64, 1, 128
    rng = np.random.default_rng(7 + S + init)
    x = rng.standard_normal((1, S, H, P)).astype(np.float32)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), H))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    dt = _softplus(rng.standard_normal((1, S, H)) + dt_bias).astype(np.float32)
    A_log = np.log(np.arange(1, H + 1, dtype=np.float32))
    Bm = rng.standard_normal((1, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((1, S, G, N)).astype(np.float32)
    D = np.ones(H, np.float32)
    s0 = rng.standard_normal((1, H, P, N)).astype(np.float32) if init else None
    xb, Bb, Cb = (torch.from_numpy(a).bfloat16() for a in (x, Bm, Cm))
    yr, sr = jssd_ref(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(dt), jnp.asarray(A_log),
                      jnp.asarray(Bb.float().numpy()), jnp.asarray(Cb.float().numpy()),
                      jnp.asarray(D), None if s0 is None else jnp.asarray(s0))
    y, s = _bf16_design(xb, torch.from_numpy(dt), torch.from_numpy(A_log), Bb, Cb,
                        torch.from_numpy(D),
                        None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(yr.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=2e-2, atol=2e-2)


def test_cuda_launches_refuse_cpu_tensors():
    """The bf16 launches and the CUDA-core design launch or raise too."""
    arrs, Q = _inputs(CASES[0])
    x, dt, A_log, Bm, Cm, D = _t(arrs)
    with pytest.raises(ValueError, match="CUDA tensors required"):
        pss.bf16_launches(x.bfloat16(), dt, A_log, Bm.bfloat16(), Cm.bfloat16(), D,
                          chunk=Q)
    with pytest.raises(ValueError, match="CUDA tensors required"):
        pss._ssd_scan_cuda_cores(x.bfloat16(), dt, A_log, Bm.bfloat16(),
                                 Cm.bfloat16(), D, chunk=Q)
    with pytest.raises(ValueError, match="bf16 x required"):
        pss._ssd_scan_cuda_cores(x, dt, A_log, Bm, Cm, D, chunk=Q)
