"""The port's dense decode model against the JAX reference on reduced
llama3.2-1b: the same parameters (``repro.models.init_params`` carried over
by ``convert.params_from_numpy``) and the same tokens give the same logits
per step, at 1e-4 in f32 (the two libraries sum in a different order),
including idle slots whose positions run past ``max_seq``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.configs import replace as jreplace
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.models.layers import lm_logits as jlm_logits
from repro.models.transformer import Impl as JImpl

from repro_torch.configs import get_config, get_reduced, replace
from repro_torch.convert import params_from_numpy
from repro_torch.models import (Impl, decode_step, forward, init_decode_state,
                                init_params)
from repro_torch.models import kvcache
from repro_torch.models.layers import lm_logits

JIMPL = JImpl(attention="naive", remat=False)
TOL = 1e-4


JCFG = jget_reduced("llama3.2-1b")
_jstep = jax.jit(lambda p, s, t: jdecode_step(JCFG, p, s, t, impl=JIMPL,
                                              dtype=jnp.float32))


@pytest.fixture(scope="module")
def both():
    cfg = get_reduced("llama3.2-1b")
    jparams = jinit_params(JCFG, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, tparams


def _run(both, start_pos, n_steps, max_seq, per_slot=True, seed=0):
    """Decode ``n_steps`` random tokens through both packages; compare the
    logits every step and the caches at the end."""
    cfg, jparams, tparams = both
    B = len(start_pos)
    jst = jinit_decode_state(JCFG, jparams, B, max_seq, dtype=jnp.float32,
                             impl=JIMPL)
    tst = init_decode_state(cfg, B, max_seq, dtype=torch.float32, device="cpu")
    if per_slot:
        jst["pos"] = jnp.asarray(start_pos, jnp.int32)
        tst["pos"] = torch.tensor(start_pos, dtype=torch.int32)
    else:
        jst["pos"] = jnp.int32(start_pos[0])
        tst["pos"] = start_pos[0]
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (n_steps, B, 1))
    for t in range(n_steps):
        jl, jst = _jstep(jparams, jst, jnp.asarray(tokens[t], jnp.int32))
        tl, tst = decode_step(cfg, tparams, tst, torch.from_numpy(tokens[t]),
                              dtype=torch.float32)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tst["caches"][k].numpy(),
                                   np.asarray(jst["caches"][k]),
                                   rtol=TOL, atol=TOL)
    assert np.array_equal(np.asarray(tst["pos"]), np.asarray(jst["pos"]))


def test_logits_match_per_slot_positions(both):
    _run(both, [0, 3, 7, 1], n_steps=12, max_seq=32)


def test_logits_match_uniform_position(both):
    _run(both, [2, 2], n_steps=12, max_seq=32, per_slot=False, seed=1)


def test_idle_slot_positions_past_max_seq_match_jax(both):
    """An idle slot's position keeps advancing past the cache; JAX clamps
    the insert to the last slot, and so does the port."""
    _run(both, [5, 7], n_steps=14, max_seq=8, seed=2)


def test_insert_rows_clamps_like_dynamic_update_slice():
    cache = kvcache.init_dense_cache(1, 2, 4, 1, 2, torch.float32, "cpu")
    layer = {"k": cache["k"][0], "v": cache["v"][0]}
    new = torch.ones((2, 1, 1, 2))
    kvcache.dense_cache_insert_rows(layer, new, 2 * new,
                                    torch.tensor([9, 1], dtype=torch.int32))
    assert cache["k"][0, 0, 3].tolist() == [[1.0, 1.0]]     # clamped to S-1
    assert cache["v"][0, 1, 1].tolist() == [[2.0, 2.0]]


def test_kernel_and_plain_impls_agree_on_cpu(both):
    cfg, _, tparams = both
    outs = []
    for impl in (Impl(), Impl(decode_attention="plain")):
        st = init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu")
        st["pos"] = torch.tensor([0, 4], dtype=torch.int32)
        logits, _ = decode_step(cfg, tparams, st, torch.tensor([[3], [5]]),
                                impl=impl, dtype=torch.float32)
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError):
        Impl(decode_attention="naive")


def test_init_params_tree_matches_reference(both):
    cfg, _, tparams = both
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    flat_ref = {k: v.shape for k, v in _flatten(tparams)}
    flat_ours = {k: v.shape for k, v in _flatten(ours)}
    assert flat_ours == flat_ref
    w = ours["blocks"]["ffn"]["up"]
    assert w.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-6   # truncated at 2σ
    assert abs(ours["embed"]["tok"].std().item() - 0.02) < 0.004


def test_bf16_forward_with_f32_params_rounds_the_head_like_jax():
    """A bf16 forward with f32 parameters: the reference rounds the head to
    bf16 and accumulates the product in f32. The stack is cut to 0 layers
    and the tied embedding scaled by 50 (logits of O(50)), so that what is
    left is embedding → final norm → head, and an f32 head (a difference of
    ~0.05 at this scale) cannot hide in bf16 noise of the blocks."""
    jcfg = jreplace(JCFG, num_layers=0)
    cfg = replace(get_reduced("llama3.2-1b"), num_layers=0)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    jparams["embed"]["tok"] = jparams["embed"]["tok"] * 50.0
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    want, _ = jforward(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                       impl=JIMPL, dtype=jnp.bfloat16)
    got, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks)},
                     dtype=torch.bfloat16)
    want = np.asarray(want)[..., :cfg.vocab_size]
    assert np.abs(want).max() > 20.0
    np.testing.assert_allclose(got.numpy()[..., :cfg.vocab_size], want,
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("tied", [True, False])
def test_lm_logits_match_jax_with_f32_head_and_bf16_input(tied):
    """The same bf16 activations and f32 head through both heads give the
    same f32 logits up to the order of f32 sums."""
    cfg = replace(get_reduced("llama3.2-1b"), tie_embeddings=tied)
    rng = np.random.default_rng(6)
    w = rng.standard_normal((256, cfg.d_model)).astype(np.float32)
    params = {"tok": w} if tied else {"tok": w, "head": np.ascontiguousarray(w.T)}
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jlm_logits(jreplace(JCFG, tie_embeddings=tied),
                                 {k: jnp.asarray(v) for k, v in params.items()},
                                 jx))
    got = lm_logits(cfg, {k: torch.from_numpy(v) for k, v in params.items()},
                    torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_full_config_is_llama3p2_1b():
    cfg = get_config("llama3.2-1b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) == \
        (16, 2048, 32, 8, 64, 8192, 128256, True)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + k + "/")
        else:
            yield prefix + k, v
