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
