"""The port's ring caches and VLM family (llava-next-mistral-7b, reduced)
against the JAX reference on the CPU, in f32, with the reference's
parameters carried over (``convert.params_from_numpy``) and the same numpy
inputs: ``init_ring_cache`` / ``ring_cache_insert``, the ring layout of
``init_decode_state`` (dense, MoE, VLM and hybrid families), the reference's
two ring tests (``tests/test_ring_cache_wrap.py``: a ring that wraps three
times equals the windowed forward; an evicted position has no influence)
through both packages, the vision prefix in the forward, the loss and every
gradient leaf (``vision_proj`` included), decode and the engine, and
checkpoints both ways.

Tolerances: cache contents exactly; the ring's decode against the windowed
forward to 3e-4 (the reference's ring test) and against the reference's
decode to 1e-4; logits to 1e-4 (as ``test_torch_model.py``); the loss to
1e-5 relative and every gradient leaf to 1e-4 of its largest |g| (as
``test_torch_train.py``); greedy engine tokens identical."""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.checkpointer as jckpt
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import replace as jreplace
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.models import kvcache as jkvcache
from repro.models import loss_fn as jloss_fn
from repro.models.transformer import Impl as JImpl
from repro.runtime import Request as JRequest
from repro.runtime import ServingEngine as JServingEngine

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_IDS, get_config, get_reduced, replace
from repro_torch.convert import params_from_numpy
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, loss_fn)
from repro_torch.models import attention as attn
from repro_torch.models import kvcache
from repro_torch.models import transformer as tf
from repro_torch.runtime import Request, ServingEngine, make_prefill_step
from repro_torch.tree import leaves, leaves_with_paths

ARCH = "llava-next-mistral-7b"
JIMPL = JImpl(attention="chunked", remat=False)
JNAIVE = JImpl(attention="naive", remat=False)
PROMPTS = [[5, 9, 2, 7], [11, 3, 8], [1, 4, 6, 10, 12]]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs (restored after): the
    suite runs six workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _batch(cfg, B, S, seed):
    """Tokens, labels masked over the vision prefix (as the synthetic data
    masks them) and patch embeddings."""
    toks = _tokens(cfg.vocab_size, B, S, seed)
    labels = toks.copy()
    labels[:, :cfg.vision_tokens] = -1
    return {"tokens": toks, "labels": labels,
            "vision_embeds": _x((B, cfg.vision_tokens, cfg.vision_dim), seed + 50, 0.1)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def llava():
    jcfg = jget_reduced(ARCH)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, get_reduced(ARCH), jparams, _port(jparams)


# -- the ring cache ---------------------------------------------------------------------

def test_init_ring_cache_layout():
    """The reference's stacked ring: k / v (L, B, W, Hkv, Dh) zeros,
    slot_pos (L, W) int32 of -1."""
    one = jkvcache.init_ring_cache(2, 8, 3, 4, jnp.float32)
    want = jkvcache.stack_caches([one] * 5)
    got = kvcache.init_ring_cache(5, 2, 8, 3, 4, torch.float32, "cpu")
    assert sorted(got) == sorted(want) == ["k", "slot_pos", "v"]
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("window", [8, 5])
def test_ring_cache_insert_matches_jax(window):
    """20 inserts into a ring of ``window`` slots (it wraps two or three
    times), one layer: the K/V and slot positions after each equal the
    reference's; the insert is in place."""
    B, W, H, D = 2, window, 3, 4
    jc = jkvcache.init_ring_cache(B, W, H, D, jnp.float32)
    c = {k: v[0] for k, v in kvcache.init_ring_cache(1, B, W, H, D, torch.float32,
                                                     "cpu").items()}
    for pos in range(20):
        k, v = _x((B, 1, H, D), pos), _x((B, 1, H, D), 100 + pos)
        jc = jkvcache.ring_cache_insert(jc, jnp.asarray(k), jnp.asarray(v),
                                        jnp.int32(pos))
        out = kvcache.ring_cache_insert(c, torch.from_numpy(k), torch.from_numpy(v), pos)
        assert out is c
        for name in ("k", "v", "slot_pos"):
            np.testing.assert_array_equal(c[name].numpy(), np.asarray(jc[name]))


def test_decode_attn_refuses_per_slot_positions_on_a_ring(llava):
    """A ring takes one position for the whole batch, as the reference
    asserts."""
    _, cfg, _, tparams = llava
    cache = {k: v[0] for k, v in kvcache.init_ring_cache(
        1, 2, 8, cfg.kv_heads_eff, cfg.head_dim, torch.float32, "cpu").items()}
    p = tf.layer(tparams["blocks"], 0)["attn"]
    with pytest.raises(ValueError, match="uniform decode positions"):
        attn.decode_attn(cfg, p, torch.zeros(2, 1, cfg.d_model), cache,
                         torch.tensor([0, 1]))


STATE_CASES = {  # arch, window, max_seq, batch
    "mixtral-dense-at-window": ("mixtral-8x7b", None, 32, 2),
    "mixtral-ring": ("mixtral-8x7b", None, 33, 2),
    "llava-ring": (ARCH, None, 100, 2),
    "llama-ring": ("llama3.2-1b", 4, 16, 1),
    "zamba2-ring": ("zamba2-2.7b", 8, 20, 2),
}


@pytest.mark.parametrize("case", list(STATE_CASES))
def test_decode_state_layout_matches_jax(case):
    """``init_decode_state``: a dense cache up to the window, a ring past
    it (the hybrid's one per insertion of its shared block), leaf for leaf
    the reference's shapes, dtypes and values."""
    arch, window, max_seq, B = STATE_CASES[case]
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    if window:
        jcfg, cfg = jreplace(jcfg, swa_window=window), replace(cfg, swa_window=window)
    jparams = jax.eval_shape(lambda k: jinit_params(jcfg, k), jax.random.PRNGKey(0))
    want = _np_tree(jinit_decode_state(jcfg, jparams, B, max_seq, dtype=jnp.float32,
                                       impl=JNAIVE)["caches"])
    got = init_decode_state(cfg, B, max_seq, dtype=torch.float32, device="cpu")["caches"]
    wl, gl = leaves_with_paths(want), leaves_with_paths(got)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, w), (_, g) in zip(wl, gl):
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
    ring = any(p.endswith("slot_pos") for p, _ in gl)
    assert ring == (max_seq > cfg.swa_window)


def _ring_cfgs(arch, window, **moe_fields):
    jcfg = jreplace(jget_reduced(arch), swa_window=window)
    cfg = replace(get_reduced(arch), swa_window=window)
    if moe_fields:
        jcfg = jreplace(jcfg, moe=jreplace(jcfg.moe, **moe_fields))
        cfg = replace(cfg, moe=replace(cfg.moe, **moe_fields))
    return jcfg, cfg


def _decode_run(cfg, params, toks, max_seq):
    st = init_decode_state(cfg, toks.shape[0], max_seq, dtype=torch.float32,
                           device="cpu")
    out = []
    for t in range(toks.shape[1]):
        lg, st = decode_step(cfg, params, st, torch.from_numpy(toks[:, t:t + 1]).long(),
                             dtype=torch.float32)
        out.append(lg[:, 0].numpy())
    return np.stack(out, 1), st


def _jdecode_run(jcfg, jparams, toks, max_seq):
    st = jinit_decode_state(jcfg, jparams, toks.shape[0], max_seq, dtype=jnp.float32,
                            impl=JNAIVE)
    step = jax.jit(lambda p, s, t: jdecode_step(jcfg, p, s, t, impl=JNAIVE,
                                                dtype=jnp.float32))
    out = []
    for t in range(toks.shape[1]):
        lg, st = step(jparams, st, jnp.asarray(toks[:, t:t + 1]))
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out, 1)


RING_CASES = {  # arch, window, tokens, max_seq, MoE fields
    # the reference's case: window 8, 24 tokens, the ring wraps 3x
    "mixtral-w8-wraps-3x": ("mixtral-8x7b", 8, 24, 32, dict(capacity_factor=8.0)),
    # llava's reduced window of 32: W + 2W tokens
    "llava-w32-wraps-3x": (ARCH, 32, 96, 64, {}),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_decode_past_three_wraps_matches_windowed_forward(case):
    """Decoding token by token on the ring equals the full-sequence forward
    with the window (3e-4, the reference's tolerance) and the reference's
    own ring decode (1e-4); the ring's slots end holding the last W
    positions."""
    arch, window, n, max_seq, moe_fields = RING_CASES[case]
    jcfg, cfg = _ring_cfgs(arch, window, **moe_fields)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = _port(jparams)
    toks = _tokens(cfg.vocab_size, 2, n, seed=1)
    want, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks).long()},
                      dtype=torch.float32)
    jwant, _ = jforward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, impl=JNAIVE,
                        dtype=jnp.float32)
    got, st = _decode_run(cfg, tparams, toks, max_seq)
    np.testing.assert_allclose(got, want.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, np.asarray(jwant), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, _jdecode_run(jcfg, jparams, toks, max_seq),
                               rtol=1e-4, atol=1e-4)
    sp = st["caches"]["slot_pos"]
    assert sp.shape == (cfg.num_layers, window) and st["pos"] == n
    assert sorted(sp[0].tolist()) == list(range(n - window, n))
    assert all(p % window == s for s, p in enumerate(sp[-1].tolist()))


def test_ring_evicts_old_positions():
    """The reference's second case: a token outside the window (position
    0, two layers of window 4, 10 tokens) has no influence on the last
    logits, in both packages, and the port's equal the reference's."""
    jcfg, cfg = _ring_cfgs("llama3.2-1b", 4)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = _port(jparams)
    t1 = _tokens(cfg.vocab_size, 1, 10, seed=2)
    t2 = t1.copy()
    t2[:, 0] = (t1[:, 0] + 7) % cfg.vocab_size
    a, _ = _decode_run(cfg, tparams, t1, 16)
    b, _ = _decode_run(cfg, tparams, t2, 16)
    np.testing.assert_allclose(a[:, -1], b[:, -1], rtol=1e-6, atol=1e-6)
    assert not np.allclose(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a, _jdecode_run(jcfg, jparams, t1, 16), rtol=1e-4,
                               atol=1e-4)


def test_ring_decode_through_jax_pallas_decode():
    """The port's ring decode against the reference's through its Pallas
    decode kernel (interpret mode), past one wrap."""
    jcfg, cfg = _ring_cfgs("llama3.2-1b", 6)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(3))
    tparams = _port(jparams)
    toks = _tokens(cfg.vocab_size, 2, 14, seed=4)
    impl = JImpl(decode_attention="pallas_decode", remat=False)
    st = jinit_decode_state(jcfg, jparams, 2, 16, dtype=jnp.float32, impl=impl)
    want = []
    for t in range(toks.shape[1]):
        lg, st = jdecode_step(jcfg, jparams, st, jnp.asarray(toks[:, t:t + 1]),
                              impl=impl, dtype=jnp.float32)
        want.append(np.asarray(lg)[:, 0])
    got, _ = _decode_run(cfg, tparams, toks, 16)
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=1e-4, atol=1e-4)


def test_hybrid_ring_decode_matches_windowed_forward():
    """The hybrid family's ring (one per insertion of its shared block,
    beside the SSM states): zamba2 reduced with a window of 8, 24 tokens
    decoded (the ring wraps 3x), against its windowed forward (3e-4) and
    the reference's ring decode (1e-4)."""
    jcfg, cfg = _ring_cfgs("zamba2-2.7b", 8)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(5))
    tparams = _port(jparams)
    toks = _tokens(cfg.vocab_size, 2, 24, seed=6)
    want, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks).long()},
                      dtype=torch.float32)
    got, st = _decode_run(cfg, tparams, toks, 32)
    assert st["caches"]["attn"]["slot_pos"].shape == (cfg.num_layers // cfg.attn_every, 8)
    np.testing.assert_allclose(got, want.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, _jdecode_run(jcfg, jparams, toks, 32), rtol=1e-4,
                               atol=1e-4)


def test_engine_still_refuses_a_ring_state(llava):
    """Past the window the engine refuses before it builds a state (its
    slot reset would corrupt a ring's slot positions)."""
    _, cfg, _, tparams = llava
    with pytest.raises(ValueError, match="ring caches"):
        ServingEngine(cfg, tparams, max_batch=2, max_seq=cfg.swa_window + 1,
                      dtype=torch.float32, device="cpu")


# -- the VLM ----------------------------------------------------------------------------

def test_init_params_tree_matches_reference(llava):
    _, cfg, jparams, _ = llava
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    want = {p: tuple(v.shape) for p, v in leaves_with_paths(_np_tree(jparams))}
    assert {p: tuple(v.shape) for p, v in leaves_with_paths(ours)} == want
    assert ours["vision_proj"]["w"].shape == (cfg.vision_dim, cfg.d_model)
    assert not ours["vision_proj"]["b"].any()


def test_forward_with_vision_prefix_matches_jax(llava):
    """The projected patches replace the first vision_tokens positions;
    the sequence passes the window (40 > 32)."""
    jcfg, cfg, jparams, tparams = llava
    batch = _batch(cfg, 2, 40, seed=1)
    want, _ = jforward(jcfg, jparams, _j(batch), impl=JIMPL, dtype=jnp.float32)
    got, aux = forward(cfg, tparams, _t(batch), dtype=torch.float32)
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    text, _ = forward(cfg, tparams, {"tokens": _t(batch)["tokens"]}, dtype=torch.float32)
    assert not np.allclose(text.numpy(), got.numpy())
    pre = make_prefill_step(cfg, dtype=torch.float32)(tparams, _t(batch))
    np.testing.assert_allclose(pre.numpy(), got[:, -1:].numpy(), rtol=1e-5, atol=1e-5)


def test_text_forward_matches_jax(llava):
    """Without patch embeddings the VLM is its text backbone."""
    jcfg, cfg, jparams, tparams = llava
    toks = _tokens(cfg.vocab_size, 2, 12, seed=2)
    want, _ = jforward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, impl=JIMPL,
                       dtype=jnp.float32)
    got, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks)}, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_loss_and_grads_match_jax(llava):
    """Every gradient leaf, ``vision_proj``'s included, against
    ``jax.grad``; the labels over the prefix are masked."""
    jcfg, cfg, jparams, _ = llava
    batch = _batch(cfg, 2, 24, seed=3)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, _j(batch), impl=JIMPL, dtype=jnp.float32),
        has_aux=True))(jparams)
    tp = _port(jparams)
    flat = [p.requires_grad_(True) for p in leaves(tp)]
    loss, metrics = loss_fn(cfg, tp, _t(batch), dtype=torch.float32)
    grads = torch.autograd.grad(loss, flat)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert sorted(metrics) == ["ce", "loss"]
    want = dict(leaves_with_paths(_np_tree(jg)))
    paths = [p for p, _ in leaves_with_paths(tp)]
    assert sorted(want) == paths and "vision_proj/w" in paths
    for path, g in zip(paths, grads):
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)
    assert np.abs(want["vision_proj/b"]).max() > 0


def test_decode_matches_jax_and_forward(llava):
    """Text decode (no vision prefix, as in the reference) on a dense cache
    inside the window, token by token against the reference's decode and
    the port's forward."""
    jcfg, cfg, jparams, tparams = llava
    toks = _tokens(cfg.vocab_size, 2, 12, seed=4)
    got, _ = _decode_run(cfg, tparams, toks, 16)
    np.testing.assert_allclose(got, _jdecode_run(jcfg, jparams, toks, 16), rtol=1e-4,
                               atol=1e-4)
    want, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks)}, dtype=torch.float32)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-4)


def test_engine_tokens_match_jax_engine(llava):
    jcfg, cfg, jparams, tparams = llava
    eng = ServingEngine(cfg, tparams, max_batch=2, max_seq=cfg.swa_window,
                        dtype=torch.float32, device="cpu")
    jeng = JServingEngine(jcfg, jparams, max_batch=2, max_seq=jcfg.swa_window,
                          impl=JNAIVE)
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(rid=i, prompt=p, max_new=4 + i))
        jeng.submit(JRequest(rid=i, prompt=p, max_new=4 + i))
    got = {r.rid: r.generated for r in eng.run_until_drained()}
    want = {r.rid: r.generated for r in jeng.run_until_drained()}
    assert got == want and eng.ticks == jeng.ticks


def test_llava_state_cross_restores(llava, monkeypatch):
    """llava's tree (with ``vision_proj``) written by either package
    restores in the other."""
    monkeypatch.setattr(jckpt, "_CODEC", "zlib")     # the port reads zlib only
    _, _, jparams, _ = llava
    host = _np_tree(jparams)
    tstate = {"params": _port(host)}
    jstate = {"params": jax.tree.map(jnp.asarray, host)}
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        Checkpointer(d1).save(2, tstate, blocking=True)
        jckpt.Checkpointer(d2).save(2, jstate, blocking=True)
        _, from_port = jckpt.Checkpointer(d1).restore(jstate)
        _, from_ref = Checkpointer(d2).restore(tstate)
        metas = [jckpt._decompress_meta(open(os.path.join(d, "step_2",
                                                          "meta.msgpack.zlib"),
                                             "rb").read(), "zlib")
                 for d in (d1, d2)]
    assert metas[0] == metas[1]
    want = dict(leaves_with_paths(host))
    for got in (from_port, from_ref):
        flat = dict(leaves_with_paths(got))
        assert sorted(flat) == sorted(f"params/{p}" for p in want)
        for p, w in want.items():
            np.testing.assert_array_equal(np.asarray(flat[f"params/{p}"]), w)


def test_serve_launcher_serves_reduced_llava(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "llava-next-mistral-7b-smoke" in out and "3 requests" in out


def test_serve_launcher_refuses_a_ring(capsys):
    """A ``--max-seq`` past the window is the engine's refusal, passed on
    as a usage error."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu", "--max-seq", "64"])
    assert "ring caches" in capsys.readouterr().err


def test_full_llava_sizes_and_the_train_refusal():
    """7.25e9 parameters: 14.5 GB of bf16 weights serve on an 80 GB card,
    116 GB of f32 training state do not; a ring of 32 x 8 x 4096 slots is
    4.3 GB where a dense cache of 32768 positions would be 34.4 GB."""
    from repro_torch.device import check_fits
    from repro_torch.launch.train import train_bytes_per_param
    cfg = get_config(ARCH)
    n = cfg.param_count()
    assert 7.2e9 < n < 7.3e9
    check_fits(ARCH, 2 * n, 80_000_000_000)
    with pytest.raises(ValueError, match="more than the card's 80.0 GB"):
        check_fits(ARCH, train_bytes_per_param(torch.float32, torch.float32) * n,
                   80_000_000_000)
    kv = 2 * cfg.num_layers * 8 * cfg.kv_heads_eff * cfg.head_dim * 2
    assert round(kv * cfg.swa_window / 1e9, 1) == 4.3
    assert round(kv * 32768 / 1e9, 1) == 34.4


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_is_ported(arch):
    """``check_ported`` admits all ten architectures, and each reduced
    model's tree is the reference's."""
    cfg = get_reduced(arch)
    tf.check_ported(cfg)
    jcfg = jget_reduced(arch)
    shapes = jax.eval_shape(lambda k: jinit_params(jcfg, k), jax.random.PRNGKey(0))
    want = {p: tuple(v.shape) for p, v in leaves_with_paths(
        jax.tree.map(lambda s: np.empty(s.shape, np.float32), shapes))}
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    assert {p: tuple(v.shape) for p, v in leaves_with_paths(ours)} == want


def test_registry_holds_the_references_ten():
    from repro.configs.registry import ARCH_IDS as JARCH_IDS
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("seed,step,batch,seq", [(0, 0, 3, 16), (7, 5, 2, 40)])
def test_synthetic_batches_equal_the_reference(seed, step, batch, seq):
    """The data stream with the family's ``vision_embeds``, batched and per row,
    bit for bit the reference's."""
    from repro.data import SyntheticDataset as JSyntheticDataset
    from repro_torch.data import SyntheticDataset
    want = JSyntheticDataset(jget_reduced(ARCH), seq, seed=seed).batch(step, batch)
    ds = SyntheticDataset(get_reduced(ARCH), seq, seed=seed)
    got = ds.batch(step, batch)
    assert sorted(got) == sorted(want) and "vision_embeds" in got
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in ds.sample(step, batch - 1).items():
        np.testing.assert_array_equal(got[k][batch - 1], v, err_msg=k)


def test_config_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(jget_reduced(ARCH))
