"""The port's differentiable attention (``FlashAttention``, whose backward is
``flash_attention_bwd_plain`` on the CPU and a CUDA kernel on the card)
against the reference: gradients of sum(out²) held to ``jax.grad`` through
``repro.kernels.flash_jnp.flash_attention_jnp`` at 5e-5, the reference's
own tolerance (``tests/test_kernels_flash.py``), over GQA, windows,
``q_pos < 0`` rows, ``kv_pos < 0`` keys, ragged lengths and Dh 16 and 80;
the log-sum-exp held to ``flash_jnp._fwd_core``'s; and the routing repairs
of ``kernels.ops`` (no gradient dropped, none refused silently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_jnp
from repro.kernels.flash_jnp import flash_attention_jnp

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs (restored after): the
    suite runs six workers on the same cores, beside timing-sensitive
    gateway tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, qc, kc, tail (kv_pos -1), pad (q_pos -2)
    (2, 17, 17, 4, 2, 16, True, None, 8, 8, 3, 0),         # GQA
    (1, 33, 33, 6, 3, 16, True, 5, 8, 8, 3, 0),            # window
    (2, 24, 24, 4, 4, 16, False, None, 8, 8, 3, 0),        # non-causal
    (1, 9, 40, 3, 3, 16, True, None, 4, 16, 3, 0),         # ragged, Sq < Skv
    (2, 20, 20, 4, 2, 16, True, None, 8, 8, 0, 3),         # q_pos < 0 rows
    (1, 40, 150, 4, 1, 80, True, 64, 16, 32, 5, 2),        # Dh 80, all at once
    (2, 130, 130, 5, 1, 80, True, None, 64, 64, 0, 0),     # Dh 80, g 5, two chunks
    (1, 140, 300, 2, 2, 16, False, 100, 32, 64, 7, 0),     # window without causal
]


def _inputs(case, seed=0):
    B, Sq, Skv, H, Hkv, Dh, causal, win, qc, kc, tail, pad = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, Dh)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    if tail:
        kp[:, -tail:] = -1
    if pad:
        qp[:, -pad:] = -2
    return q, k, v, qp, kp


def _port_grads(q, k, v, qp, kp, causal, win):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ops.attention(qt, kt, vt, torch.from_numpy(qp), torch.from_numpy(kp),
                        causal=causal, window=win)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    return out, torch.autograd.grad((out ** 2).sum(), (qt, kt, vt))


@pytest.mark.parametrize("case", CASES)
def test_grads_match_flash_jnp(case):
    causal, win, qc, kc = case[6], case[7], case[8], case[9]
    q, k, v, qp, kp = _inputs(case)

    def loss(q, k, v):
        return (flash_attention_jnp(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                                    causal=causal, window=win, q_chunk=qc,
                                    kv_chunk=kc) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    out, got = _port_grads(q, k, v, qp, kp, causal, win)
    ref_out = flash_attention_jnp(q, k, v, qp, kp, causal=causal, window=win,
                                  q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=2e-5, atol=2e-5)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5,
                                   err_msg=name)
    if case[11]:                                   # q_pos < 0 rows: no gradient
        assert float(got[0][:, -case[11]:].abs().max()) == 0.0
    if case[10]:                                   # kv_pos < 0 keys: none either
        assert float(got[1][:, -case[10]:].abs().max()) == 0.0
        assert float(got[2][:, -case[10]:].abs().max()) == 0.0


@pytest.mark.parametrize("case", CASES)
def test_lse_matches_fwd_core(case):
    """Live rows to 1e-5; rows the reference finds dead are NEG_INF, and so
    is every q_pos < 0 row (its output is the constant 0)."""
    causal, win, qc, kc = case[6], case[7], case[8], case[9]
    q, k, v, qp, kp = _inputs(case, seed=1)
    Sq = q.shape[1]
    pq, pk = flash_jnp._pad_to(jnp.asarray(qp), 1, qc, -2), flash_jnp._pad_to(
        jnp.asarray(kp), 1, kc, -1)
    pad = lambda x, m: flash_jnp._pad_to(jnp.asarray(x), 1, m, 0)
    _, want = flash_jnp._fwd_core(pad(q, qc), pad(k, kc), pad(v, kc), pq, pk, causal,
                                  win, qc, kc)
    want = np.asarray(want)[:, :Sq]
    _, got = fa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, qp, kp)),
                                      causal=causal, window=win, return_lse=True)
    got = got.numpy()
    live = (qp >= 0)[:, :, None] & (want > NEG_INF / 2)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)
    assert np.all(got[~live] == NEG_INF)


def test_noncausal_masked_rows_get_the_true_gradient():
    """A q_pos < 0 row with valid keys (non-causal): its output is the
    constant 0, so it passes no gradient (autograd through a dense masked
    softmax in f64 agrees); the reference's backward differs here."""
    case = (2, 20, 30, 4, 2, 16, False, None, 8, 8, 2, 4)
    q, k, v, qp, kp = _inputs(case, seed=2)
    _, got = _port_grads(q, k, v, qp, kp, False, None)
    qt, kt, vt = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
                  for x in (q, k, v))
    ke, ve = kt.repeat_interleave(2, 2), vt.repeat_interleave(2, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", qt, ke) * 16 ** -0.5
    ok = torch.from_numpy(kp >= 0)[:, None, None, :]
    p = torch.softmax(s.masked_fill(~ok, -torch.inf), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, ve)
    o = torch.where(torch.from_numpy(qp < 0)[:, :, None, None], 0.0, o)
    want = torch.autograd.grad((o ** 2).sum(), (qt, kt, vt))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-5, atol=5e-5,
                                   err_msg=name)


def test_attention_without_grad_stays_on_the_plain_forward():
    q, k, v, qp, kp = _inputs(CASES[0])
    t = [torch.from_numpy(x) for x in (q, k, v, qp, kp)]
    ops.LAUNCHES.reset()
    with torch.no_grad():
        out = ops.attention(*[x.requires_grad_(True) if x.is_floating_point() else x
                              for x in t])
    assert out.grad_fn is None
    assert ops.LAUNCHES.snapshot()["flash_attention"] == 0   # the CPU counts nothing


@pytest.mark.parametrize("grad_mode,requires,raises", [
    (True, True, True), (True, False, False), (False, True, False)])
def test_refuse_grad(grad_mode, requires, raises):
    """The helper behind ops.decode_attention and ops.ssd on CUDA tensors:
    it raises, naming the missing backward, only when autograd would need
    it."""
    x = torch.ones(3, requires_grad=requires)
    with torch.set_grad_enabled(grad_mode):
        if raises:
            with pytest.raises(RuntimeError, match="ssd_scan: the CUDA kernel has no backward"):
                ops.refuse_grad("ssd_scan", None, torch.ones(2), x)
        else:
            ops.refuse_grad("ssd_scan", None, torch.ones(2), x)


def test_cpu_ssd_and_decode_still_differentiate():
    """On the CPU both differentiate: the SSD through ``ops.SSDScan``,
    whose plain backward (explicit formulas) agrees with autograd through
    the plain forward to 1e-5, and decode attention through autograd (the
    refusal is for its CUDA kernel only)."""
    from repro_torch.kernels import ssd_scan as ss
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((1, 20, 4, 8)).astype(np.float32),
                     requires_grad=True)
    dt = torch.full((1, 20, 4), 0.1)
    Bm = torch.tensor(rng.standard_normal((1, 20, 1, 8)).astype(np.float32))
    y, _ = ops.ssd(x, dt, torch.zeros(4), Bm, Bm.clone(), torch.ones(4), chunk=8)
    (gx,) = torch.autograd.grad(y.sum(), (x,))
    want, _ = ss.ssd_scan_plain(x, dt, torch.zeros(4), Bm, Bm.clone(), torch.ones(4),
                                chunk=8)
    (wx,) = torch.autograd.grad(want.sum(), (x,))
    assert torch.isfinite(gx).all()
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-5)
    q, k, v, qp, kp = _inputs((1, 1, 12, 4, 2, 16, True, None, 8, 8, 2, 0))
    qt = torch.tensor(q, requires_grad=True)
    o = ops.decode_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(qp), torch.from_numpy(kp))
    (gq,) = torch.autograd.grad(o.sum(), (qt,))
    assert torch.isfinite(gq).all() and gq.abs().max() > 0


# ---------------------------------------------------------------------------
# The bf16 kernels' rounding points, as a design model; wrapper refusals; the
# build hash over the shared header
# ---------------------------------------------------------------------------

def _bf(t):
    """t rounded to bf16, as f32."""
    return t.to(torch.bfloat16).float()


def _wgmma_bwd_model(q, k, v, out, lse, dout, qp, kp, causal, window):
    """dq, dk, dv as ``flash_bwd_dkdv_wgmma`` / ``flash_bwd_dq_wgmma`` form
    them, dense: bf16 operands; S, dP and P (masked before exp, dead rows
    P = 0) in f32; dS = P ∘ (dP − Δ) in f32, Δ from the bf16 output; P and
    dS rounded to bf16 as the A operands of dV += Pᵀ·dO, dK += dSᵀ·Q and dQ
    += dS·K, whose sums are f32; dk and dq scaled once; the results rounded
    to bf16."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = Dh ** -0.5
    kk = k.repeat_interleave(g, dim=2)
    vv = v.repeat_interleave(g, dim=2)
    ok = fa._valid(qp, kp, causal, window)[:, 0]                  # (B, 1, q, k)
    live = ((lse > NEG_INF / 2) & (qp >= 0)[:, :, None]).permute(0, 2, 1)[..., None]
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    p = torch.where(ok & live, torch.exp(s - lse.permute(0, 2, 1)[..., None]),
                    torch.zeros(()))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, vv)
    delta = (out * dout).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf(ds), kk) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf(ds), q).reshape(
        B, -1, Hkv, g, Dh).sum(3) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf(p), dout).reshape(B, -1, Hkv, g, Dh).sum(3)
    return _bf(dq), _bf(dk), _bf(dv)


MODEL_CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, tail (kv_pos -1), pad (q_pos -2)
    (1, 72, 72, 4, 4, 64, True, None, 0, 0),     # g 1
    (1, 70, 90, 8, 2, 64, True, None, 3, 2),     # g 4, ragged
    (2, 65, 65, 5, 1, 64, True, 24, 0, 0),       # g 5, window
    (1, 72, 72, 2, 2, 80, True, None, 0, 3),     # Dh 80
    (1, 40, 100, 8, 2, 80, False, None, 5, 0),   # Dh 80, g 4, non-causal
    (1, 66, 66, 5, 1, 80, True, None, 0, 0),     # zamba2's Dh 80, g 5
    (1, 64, 64, 2, 2, 128, True, None, 2, 0),    # Dh 128
    (1, 50, 80, 4, 1, 128, True, 30, 0, 1),      # Dh 128, g 4
    (1, 33, 33, 5, 1, 128, True, None, 0, 0),    # Dh 128, g 5
]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_wgmma_rounding_model_within_the_bf16_tolerance(case):
    """The bf16 kernels' rounding points against ``flash_attention_bwd_plain``
    in f32 on the same bf16-valued inputs, forward output and log-sum-exp,
    |got − want| <= 2e-2·(1 + |want|) as the card's check holds the kernel
    (Dh 64, 80 and 128; g 1, 4 and 5); q_pos < 0 rows get dq 0 and kv_pos
    < 0 keys dk = dv = 0 exactly."""
    B, Sq, Skv, H, Hkv, Dh, causal, win, tail, pad = case
    q, k, v, qp, kp = _inputs((B, Sq, Skv, H, Hkv, Dh, causal, win, 8, 8, tail, pad),
                              seed=11)
    q, k, v = (_bf(torch.from_numpy(a)) for a in (q, k, v))
    qp, kp = torch.from_numpy(qp), torch.from_numpy(kp)
    out, lse = fa.flash_attention_plain(q, k, v, qp, kp, causal=causal, window=win,
                                        return_lse=True)
    out = _bf(out)
    rng = np.random.default_rng(12)
    dout = _bf(torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)))
    args = (q, k, v, out, lse, dout, qp, kp)
    got = _wgmma_bwd_model(*args, causal, win)
    want = fa.flash_attention_bwd_plain(*args, causal=causal, window=win)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        excess = ((g_ - w_).abs() - 2e-2 * (1 + w_.abs())).max().item()
        assert excess <= 0, (name, excess)
    if pad:
        assert got[0][:, -pad:].abs().max().item() == 0.0
    if tail:
        assert got[1][:, -tail:].abs().max().item() == 0.0
        assert got[2][:, -tail:].abs().max().item() == 0.0


def test_bwd_wrappers_refuse_cpu_and_f32_for_the_earlier_design():
    """The CUDA backward never falls back to the plain version; the earlier
    mma.sync design takes bf16 only."""
    q, k, v, qp, kp = map(torch.from_numpy, _inputs(CASES[0]))
    out, lse = fa.flash_attention_plain(q, k, v, qp, kp, return_lse=True)
    args = (q, k, v, out, lse, out.clone(), qp, kp)
    with pytest.raises(ValueError, match="CUDA tensors required"):
        fa.flash_attention_bwd_cuda(*args)
    with pytest.raises(ValueError, match="bf16 q/k/v required"):
        fa._flash_attention_bwd_mma_sync(*args)
    bf = [t.to(torch.bfloat16) if t.is_floating_point() and t is not lse else t
          for t in args]
    with pytest.raises(ValueError, match="CUDA tensors required"):
        fa._flash_attention_bwd_mma_sync(*bf)


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """A kernel library's name hashes its source, every header under
    ``csrc/`` and the flags: editing the shared header (hopper.cuh) names
    new libraries, so a stale build is never loaded."""
    from repro_torch.kernels import _build
    (tmp_path / "a.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("a")
    assert first == _build.library_path("a")
    (tmp_path / "hopper.cuh").write_text("// two\n")
    second = _build.library_path("a")
    (tmp_path / "a.cu").write_text('#include "hopper.cuh"\n// edited\n')
    third = _build.library_path("a")
    assert len({first, second, third}) == 3
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith("liba-")
               for p in (first, second, third))


def test_the_port_ships_its_shared_header():
    """Both flash sources and the SSD scan include the shared header, which
    the build hashes."""
    from repro_torch.kernels import _build
    assert (_build.CSRC / "hopper.cuh").is_file()
    for name in ("flash_attention", "flash_attention_bwd", "ssd_scan"):
        assert '#include "hopper.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
