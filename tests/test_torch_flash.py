"""The port's full-sequence attention on the CPU (its plain version) against
the JAX reference: ``repro.kernels.ops.attention(impl="pallas")`` (the
Pallas kernel in interpret mode, padded as the reference pads it) and
``attention_ref``, on the six shape cases and the dtype sweep of
``tests/test_kernels_flash.py`` at the reference's tolerances (2e-5 in f32,
2e-2 in bf16). Inputs are made with numpy from a seed and handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import attention as jattention
from repro.kernels.ref import attention_ref as jattention_ref

from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops

CASES = [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, qc, kc
    (2, 17, 17, 4, 2, 8, True, None, 8, 8),
    (1, 33, 33, 6, 3, 16, True, 5, 8, 8),
    (2, 1, 40, 4, 2, 8, True, None, 8, 8),       # decode shape
    (2, 24, 24, 4, 4, 8, False, None, 8, 8),     # MHA, non-causal (cross-attn)
    (1, 64, 64, 2, 1, 32, True, 16, 16, 16),     # SWA
    (1, 9, 40, 3, 3, 8, True, None, 4, 16),      # ragged chunking
]


def _inputs(case, dtype=np.float32, seed=0):
    B, Sq, Skv, H, Hkv, Dh = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, Dh)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    if Skv > 8:
        kp[:, -3:] = -1                          # unfilled cache slots
    return q, k, v, qp, kp


def _torch(arrs, dtype=torch.float32):
    q, k, v, qp, kp = (torch.from_numpy(a) for a in arrs)
    return q.to(dtype), k.to(dtype), v.to(dtype), qp, kp


def _jax(arrs, dtype=jnp.float32):
    q, k, v, qp, kp = (jnp.asarray(a) for a in arrs)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype), qp, kp


@pytest.mark.parametrize("case", CASES)
def test_matches_pallas_kernel_and_ref(case):
    causal, win, qc, kc = case[6:]
    arrs = _inputs(case)
    want_pallas = np.asarray(jattention(*_jax(arrs), causal=causal, window=win,
                                        impl="pallas", q_chunk=qc, kv_chunk=kc))
    want_ref = np.asarray(jattention_ref(*_jax(arrs), causal=causal, window=win))
    got = ops.attention(*_torch(arrs), causal=causal, window=win).numpy()
    np.testing.assert_allclose(got, want_pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", [
    (1, 300, 300, 4, 2, 16, True, None),         # ragged over three q/kv chunks
    (2, 200, 333, 2, 2, 8, False, None),         # non-causal, Skv != Sq
    (1, 257, 257, 4, 1, 8, True, 100),           # window across chunks
])
def test_long_sequences_match_ref(case):
    """Sequences longer than one chunk of the plain version, with ragged
    last chunks, equal the reference."""
    causal, win = case[6:]
    arrs = _inputs(case, seed=1)
    want = np.asarray(jattention_ref(*_jax(arrs), causal=causal, window=win))
    got = ops.attention(*_torch(arrs), causal=causal, window=win).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tdtype,jdtype,tol", [
    (torch.float32, jnp.float32, 2e-5), (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_dtypes(tdtype, jdtype, tol):
    case = (2, 32, 32, 4, 2, 16, True, None, 8, 8)
    arrs = _inputs(case, seed=2)
    ref = np.asarray(jattention_ref(*_jax(arrs, jdtype), causal=True)
                     .astype(jnp.float32))
    pallas = np.asarray(jattention(*_jax(arrs, jdtype), causal=True,
                                   impl="pallas", q_chunk=8, kv_chunk=8)
                        .astype(jnp.float32))
    got = ops.attention(*_torch(arrs, tdtype), causal=True)
    assert got.dtype == tdtype
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=tol, atol=tol)


def test_padded_query_rows_are_exactly_zero():
    """Queries with q_pos < 0 (padding) produce exactly 0."""
    case = (1, 8, 8, 2, 2, 8)
    q, k, v, qp, kp = _inputs(case)
    qp[:, -2:] = -2
    out = ops.attention(*_torch((q, k, v, qp, kp)), causal=True)
    assert out[:, -2:].abs().max().item() == 0.0
    assert out[:, :-2].abs().max().item() > 0.0


def test_out_of_order_positions_match_ref():
    """Positions in any order (ring slots): the mask is read from them, not
    from the indices."""
    case = (2, 12, 30, 4, 2, 8)
    q, k, v, qp, kp = _inputs(case, seed=3)
    kp = np.stack([np.random.default_rng(b).permutation(30) for b in range(2)]
                  ).astype(np.int32)
    kp[:, ::7] = -1
    qp = np.broadcast_to(np.arange(18, 30, dtype=np.int32), (2, 12)).copy()
    arrs = (q, k, v, qp, kp)
    want = np.asarray(jattention_ref(*_jax(arrs), causal=True, window=9))
    got = ops.attention(*_torch(arrs), causal=True, window=9).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    arrs = _torch(_inputs(CASES[0]))
    ops.LAUNCHES.reset()
    got = ops.attention(*arrs, causal=True)
    assert torch.equal(got, pfa.flash_attention_plain(*arrs, causal=True))
    assert ops.LAUNCHES.snapshot()["flash_attention"] == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back to the plain version."""
    with pytest.raises(ValueError, match="CUDA tensors required"):
        pfa.flash_attention_cuda(*_torch(_inputs(CASES[0])), causal=True)


def _bf16_design(q, k, v, qp, kp, *, causal, window, tile=64):
    """The bf16 kernel's arithmetic in plain torch: f32 scores and online
    softmax over kv tiles of 64 rows, P rounded to bf16 before P·V while l
    sums the f32 p, f32 accumulation, the output rounded to bf16 once."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, g, Dh)
    m = torch.full((B, Hkv, g, Sq), float("-inf"))
    l = torch.zeros((B, Hkv, g, Sq))
    acc = torch.zeros((B, Hkv, g, Sq, Dh))
    for k0 in range(0, k.shape[1], tile):
        kt, vt = k[:, k0:k0 + tile].float(), v[:, k0:k0 + tile].float()
        ok = pfa._valid(qp, kp[:, k0:k0 + tile], causal, window)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt) * Dh ** -0.5
        s = torch.where(ok, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_sub = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - m_sub)
        p = torch.exp(s - m_sub[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.bfloat16().float(), vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where((qp < 0)[:, None, None, :, None], 0.0, out)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).bfloat16()


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, H, Hkv, Dh, causal, window, layout
    (1, 256, 256, 32, 8, 64, True, None, "ordered"),   # llama3.2-1b's heads
    (1, 200, 256, 32, 8, 64, True, 100, "ring"),       # window across tiles, ring slots
    (2, 130, 190, 16, 4, 128, True, None, "perm"),     # Dh 128, ragged, any order
    (1, 96, 160, 32, 8, 64, False, 70, "ordered"),     # non-causal window
])
def test_bf16_design_within_tolerance_of_reference(case):
    """P rounded to bf16 for P·V (the tensor-core kernel's one rounding
    point beyond its operands) stays within the bf16 tolerance, 2e-2, of
    the JAX reference at full head widths."""
    B, Sq, Skv, H, Hkv, Dh, causal, win, layout = case
    q, k, v, qp, kp = _inputs((B, Sq, Skv, H, Hkv, Dh), seed=5)
    if layout == "ring":
        kp = np.broadcast_to((np.arange(Skv) + 7 * Skv // 10) % Skv + 5000,
                             (B, Skv)).astype(np.int32).copy()
        qp = qp + 5000
    elif layout == "perm":
        kp = np.stack([np.random.default_rng(b).permutation(Skv) for b in range(B)]
                      ).astype(np.int32)
        kp[:, ::11] = -1
    arrs = (q, k, v, qp, kp)
    want = np.asarray(jattention_ref(*_jax(arrs, jnp.bfloat16), causal=causal,
                                     window=win).astype(jnp.float32))
    got = _bf16_design(*_torch(arrs, torch.bfloat16), causal=causal, window=win)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_cuda_core_design_refuses_cpu_tensors():
    """The CUDA-core design kept as a yardstick launches or raises too."""
    arrs = _torch(_inputs((1, 8, 8, 2, 2, 64)), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors required"):
        pfa._flash_attention_cuda_cores(*arrs, causal=True)
    with pytest.raises(ValueError, match="bf16 q/k/v required"):
        pfa._flash_attention_cuda_cores(*(t.float() if t.is_floating_point() else t
                                          for t in arrs), causal=True)
