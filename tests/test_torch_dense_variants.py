"""The rest of the dense family in the port (olmo-1b: non-parametric
LayerNorm, MHA at Dh 128; qwen3-14b: qk_norm; smollm-360m: 15 heads over 5)
against the JAX reference on the CPU, in f32 at the reduced configs, with
the reference's parameters carried over (``convert.params_from_numpy``) and
the same numpy inputs; head padding; and the four repairs that these
configurations needed (norms without a scale, norm trees as the
reference's, ``dense_init`` drawn in bounded slices, a sliding window on a
dense cache).

Tolerances: norms to 1e-6; a padded layout gives the unpadded attention and
logits to 1e-5; logits to 1e-4 (as ``test_torch_model.py``); the loss to
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
from repro.models import attention as jattn
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import loss_fn as jloss_fn
from repro.models.transformer import Impl as JImpl
from repro.runtime import Request as JRequest
from repro.runtime import ServingEngine as JServingEngine

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_reduced, replace
from repro_torch.convert import params_from_numpy
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, loss_fn)
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.runtime import Request, ServingEngine
from repro_torch.tree import leaves, leaves_with_paths

ARCHS = ["olmo-1b", "qwen3-14b", "smollm-360m"]
JIMPL = JImpl(attention="chunked", remat=False)
# the reference's head-padding cases (tests/test_head_padding.py)
PADS = {"qwen3-14b": dict(pad_q_heads=8, pad_kv_heads=4),     # reduced 4/2
        "smollm-360m": dict(pad_q_heads=8, pad_kv_heads=2)}   # reduced 3/1


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


def _shapes(tree):
    """The tree's nested dict structure with each leaf's shape; empty
    dicts stay."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _batch(vocab, B, S, seed, masked=3):
    toks = _tokens(vocab, B, S, seed)
    labels = toks.copy()
    labels[:, :masked] = -1
    return {"tokens": toks, "labels": labels}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jget_reduced(arch)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    return arch, jcfg, jparams, _port(jparams)


# -- norms ---------------------------------------------------------------------

NORMS = {
    "np_layernorm": (lambda x, w, b: jlayers.np_layernorm(x, 1e-5),
                     lambda x, w, b: layers.np_layernorm(x, 1e-5)),
    "layer_norm": (lambda x, w, b: jlayers.layer_norm(x, w, b, 1e-5),
                   lambda x, w, b: layers.layer_norm(x, w, b, 1e-5)),
    "layer_norm_no_bias": (lambda x, w, b: jlayers.layer_norm(x, w, None, 1e-5),
                           lambda x, w, b: layers.layer_norm(x, w, None, 1e-5)),
    "rms_norm": (lambda x, w, b: jlayers.rms_norm(x, w, 1e-5),
                 lambda x, w, b: layers.rms_norm(x, w, 1e-5)),
}


@pytest.mark.parametrize("name", list(NORMS))
def test_norms_match_jax(name):
    """Inputs off zero mean (the mean matters) and a row of equal values
    (variance 0: eps keeps it finite); the population variance in f32."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1.5).astype(np.float32)
    x[0, 0] = 2.0
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jfn, tfn = NORMS[name]
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tfn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "np_layernorm", "layernorm"])
def test_apply_norm_dispatches_like_the_reference(norm_type):
    jcfg = jreplace(jget_reduced("llama3.2-1b"), norm_type=norm_type)
    cfg = replace(get_reduced("llama3.2-1b"), norm_type=norm_type)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 64)) + 0.7).astype(np.float32)
    jp = jlayers.init_norm(jcfg, None)
    if "scale" in jp:
        jp = {k: v + jnp.asarray(rng.standard_normal(64), jnp.float32)
              for k, v in jp.items()}
    tp = layers.init_norm(cfg, device="cpu")
    assert _shapes(tp) == _shapes(jp)
    tp = _port(jp)
    want = np.asarray(jlayers.apply_norm(jcfg, jp, jnp.asarray(x)))
    got = layers.apply_norm(cfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- init trees (repair b) -------------------------------------------------------

INIT_CASES = {arch: (arch, {}) for arch in ARCHS}
INIT_CASES.update({f"{arch}-padded": (arch, pads) for arch, pads in PADS.items()})
INIT_CASES["llama3.2-1b-layernorm"] = ("llama3.2-1b", dict(norm_type="layernorm"))


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_init_params_tree_matches_reference(case):
    """Every path and shape of the reference's ``init_params``, empty norm
    dicts included (np_layernorm: ``{}``; layernorm: scale and bias)."""
    arch, fields = INIT_CASES[case]
    jcfg = jreplace(jget_reduced(arch), **fields)
    cfg = replace(get_reduced(arch), **fields)
    want = _shapes(jax.eval_shape(lambda k: jinit_params(jcfg, k),
                                  jax.random.PRNGKey(0)))
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    assert _shapes(ours) == want
    if cfg.norm_type == "np_layernorm":
        assert ours["final_norm"] == {} and ours["blocks"]["ln1"] == {}
    if cfg.norm_type == "layernorm":
        assert sorted(ours["blocks"]["ln2"]) == ["bias", "scale"]
        assert torch.all(ours["final_norm"]["bias"] == 0)


def test_num_layers_reads_any_leaf():
    """Repair a: olmo's stacks have no norm leaf; the layer count comes
    from the other leaves, and a decode step runs."""
    cfg = get_reduced("olmo-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    blocks = {**params["blocks"], "ln1": {}, "ln2": {}}
    assert tf.num_layers(blocks) == cfg.num_layers
    assert len(tf.layers(params["blocks"])) == cfg.num_layers
    st = init_decode_state(cfg, 2, 8, dtype=torch.float32, device="cpu")
    logits, st = decode_step(cfg, params, st, torch.zeros((2, 1), dtype=torch.long),
                             dtype=torch.float32)
    assert logits.shape == (2, 1, 256) and st["pos"] == 1


# -- dense_init in bounded slices (repair c) ---------------------------------------

def test_dense_init_draws_in_bounded_slices(monkeypatch):
    """A stack whose f32 draw would pass ``_DRAW_ELEMS`` is drawn in slices
    of its leading axes (layer by layer, then rows of a layer), each at most
    that size, cast as it is drawn: the truncated normal of the reference,
    scaled by 1/sqrt(fan_in)."""
    sizes = []
    draw = torch.nn.init.trunc_normal_

    def recording(t, *a, **k):
        sizes.append(t.numel())
        return draw(t, *a, **k)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", recording)
    monkeypatch.setattr(layers, "_DRAW_ELEMS", 1000)
    w = layers.dense_init(torch.Generator().manual_seed(0), (4, 30, 50), 30,
                          torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (4, 30, 50)
    assert max(sizes) <= 1000 and sum(sizes) == w.numel()
    wf = w.float()
    assert wf.abs().max().item() <= 2 / 30 ** 0.5 * 1.01
    assert 0.7 < wf.std().item() * 30 ** 0.5 < 1.0      # ±2σ truncation: 0.88
    layer_rows = [n for n in sizes if n == 20 * 50]       # 20 rows of a layer
    assert len(layer_rows) == 4


def test_dense_init_below_the_cap_keeps_the_cpu_stream():
    """Tensors up to ``_DRAW_ELEMS`` are one draw, as before the cap: the
    CPU streams of the seeded inits are unchanged."""
    shape = (2, 64, 4, 16)
    got = layers.dense_init(torch.Generator().manual_seed(3), shape, 64,
                            torch.float32)
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, t.mul_(1 / 8))


# -- the models against the reference --------------------------------------------------

def test_forward_matches_jax(model):
    arch, jcfg, jparams, tparams = model
    toks = _tokens(jcfg.vocab_size, 2, 40, seed=1)
    want, _ = jforward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, impl=JIMPL,
                       dtype=jnp.float32)
    got, aux = forward(get_reduced(arch), tparams,
                       {"tokens": torch.from_numpy(toks).long()}, dtype=torch.float32)
    V = jcfg.vocab_size
    assert aux == {}
    np.testing.assert_allclose(got.numpy()[..., :V], np.asarray(want)[..., :V],
                               rtol=1e-4, atol=1e-4)


def test_loss_and_grads_match_jax(model):
    arch, jcfg, jparams, _ = model
    batch = _batch(jcfg.vocab_size, 2, 40, seed=2)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                           impl=JIMPL, dtype=jnp.float32), has_aux=True))(jparams)
    tp = _port(jparams)
    flat = [p.requires_grad_(True) for p in leaves(tp)]
    loss, metrics = loss_fn(get_reduced(arch), tp,
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            dtype=torch.float32)
    grads = torch.autograd.grad(loss, flat)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert sorted(metrics) == ["ce", "loss"]
    want = dict(leaves_with_paths(_np_tree(jg)))
    assert sorted(want) == [p for p, _ in leaves_with_paths(tp)]
    for (path, _), g in zip(leaves_with_paths(tp), grads):
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_decode_matches_forward(model):
    arch, _, _, tparams = model
    cfg = get_reduced(arch)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 12, seed=3)).long()
    want, _ = forward(cfg, tparams, {"tokens": toks}, dtype=torch.float32)
    st = init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, st = decode_step(cfg, tparams, st, toks[:, t:t + 1], dtype=torch.float32)
        outs.append(lg[:, 0])
    V = cfg.vocab_size
    torch.testing.assert_close(torch.stack(outs, 1)[..., :V], want[..., :V],
                               rtol=2e-4, atol=2e-4)


PROMPTS = [[5, 9, 2], [7, 7, 1, 3, 200], [11], [4, 8, 15, 16, 23, 42], [1, 2]]


def _engine_tokens(cfg, params, jcfg=None, jparams=None, max_seq=32):
    eng = ServingEngine(cfg, params, max_batch=2, max_seq=max_seq,
                        dtype=torch.float32, device="cpu")
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(rid=i, prompt=p, max_new=4 + i))
    got = {r.rid: r.generated for r in eng.run_until_drained()}
    if jcfg is None:
        return got, None
    jeng = JServingEngine(jcfg, jparams, max_batch=2, max_seq=max_seq,
                          impl=JImpl(attention="naive", remat=False))
    for i, p in enumerate(PROMPTS):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=4 + i))
    want = {r.rid: r.generated for r in jeng.run_until_drained()}
    assert eng.ticks == jeng.ticks
    return got, want


def test_engine_tokens_match_jax_engine(model):
    arch, jcfg, jparams, tparams = model
    got, want = _engine_tokens(get_reduced(arch), tparams, jcfg, jparams)
    assert got == want


# -- head padding ---------------------------------------------------------------------

def _embed_padded(cfg, cfg_pad, attn_p):
    """Place a stacked attention's real heads (numpy, leading L axis) into
    the zeroed padded layout, as ``tests/test_head_padding.py`` does for
    one layer."""
    H, Hkv, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    Hp, Hkvp = cfg_pad.q_heads_eff, cfg_pad.kv_heads_eff
    g, gp = H // Hkv, Hp // Hkvp
    L = attn_p["wq"].shape[0]
    wq = np.zeros((L, D, Hkvp, gp, Dh), np.float32)
    wq[:, :, :Hkv, :g] = attn_p["wq"].reshape(L, D, Hkv, g, Dh)
    wo = np.zeros((L, Hkvp, gp, Dh, D), np.float32)
    wo[:, :Hkv, :g] = attn_p["wo"].reshape(L, Hkv, g, Dh, D)
    wk = np.zeros((L, D, Hkvp, Dh), np.float32)
    wk[:, :, :Hkv] = attn_p["wk"]
    wv = np.zeros((L, D, Hkvp, Dh), np.float32)
    wv[:, :, :Hkv] = attn_p["wv"]
    out = {"wq": wq.reshape(L, D, Hp, Dh), "wk": wk, "wv": wv,
           "wo": wo.reshape(L, Hp, Dh, D)}
    return {**attn_p, **out}


@pytest.fixture(scope="module", params=list(PADS))
def padded(request):
    """(arch, cfg, cfg_pad, jcfg_pad, unpadded params (numpy), the same
    weights in the padded layout (numpy))."""
    arch = request.param
    jcfg = jget_reduced(arch)
    jparams = _np_tree(jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(5)))
    cfg = get_reduced(arch)
    cfg_pad = replace(cfg, **PADS[arch])
    pparams = dict(jparams, blocks=dict(jparams["blocks"], attn=_embed_padded(
        cfg, cfg_pad, jparams["blocks"]["attn"])))
    return arch, cfg, cfg_pad, jreplace(jcfg, **PADS[arch]), jparams, pparams


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_padded_attention_equals_unpadded(padded, impl):
    """One layer's attention: the padded layout gives the unpadded output
    in the port, and the reference's padded output, to 1e-5."""
    arch, cfg, cfg_pad, jcfg_pad, p0, p1 = padded
    a0 = {k: v[0] for k, v in p0["blocks"]["attn"].items()}
    a1 = {k: v[0] for k, v in p1["blocks"]["attn"].items()}
    x = np.random.default_rng(6).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32)[None], (2, 16))
    y0 = attn.apply_attn(cfg, _port(a0), torch.from_numpy(x),
                         positions=torch.from_numpy(pos.copy()), impl=impl)
    y1 = attn.apply_attn(cfg_pad, _port(a1), torch.from_numpy(x),
                         positions=torch.from_numpy(pos.copy()), impl=impl)
    jy1 = jattn.apply_attn(jcfg_pad, a1, jnp.asarray(x), positions=jnp.asarray(pos),
                           impl="naive")
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), rtol=1e-5, atol=1e-5)


def test_padded_forward_equals_unpadded(padded):
    """The whole model: converted padded parameters give the unpadded
    logits (1e-5) and the reference's padded forward (1e-4)."""
    arch, cfg, cfg_pad, jcfg_pad, p0, p1 = padded
    toks = _tokens(cfg.vocab_size, 2, 24, seed=7)
    t = {"tokens": torch.from_numpy(toks).long()}
    l0, _ = forward(cfg, _port(p0), t, dtype=torch.float32)
    l1, _ = forward(cfg_pad, _port(p1), t, dtype=torch.float32)
    jl1, _ = jforward(jcfg_pad, jax.tree.map(jnp.asarray, p1),
                      {"tokens": jnp.asarray(toks)}, impl=JIMPL, dtype=jnp.float32)
    V = cfg.vocab_size
    np.testing.assert_allclose(l1.numpy()[..., :V], l0.numpy()[..., :V],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l1.numpy()[..., :V], np.asarray(jl1)[..., :V],
                               rtol=1e-4, atol=1e-4)


def test_padded_engine_tokens_equal_unpadded(padded):
    """Decode over the padded KV heads (k = v = 0 in the pad heads) gives
    the unpadded engine's greedy tokens."""
    arch, cfg, cfg_pad, _, p0, p1 = padded
    got, _ = _engine_tokens(cfg_pad, _port(p1))
    want, _ = _engine_tokens(cfg, _port(p0))
    assert got == want


def test_padded_init_zero_rows(padded):
    """The port's own padded init: pad rows of wq, wk, wv and wo are zero,
    real ones are not (the reference's ``test_padded_init_zero_rows``)."""
    arch, cfg, cfg_pad, *_ = padded
    p = init_params(cfg_pad, torch.Generator().manual_seed(0))["blocks"]["attn"]
    H, Hkv, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    Hkvp = cfg_pad.kv_heads_eff
    gp, g = cfg_pad.q_heads_eff // Hkvp, H // Hkv
    L = cfg.num_layers
    wq = p["wq"].reshape(L, D, Hkvp, gp, Dh)
    wo = p["wo"].reshape(L, Hkvp, gp, Dh, D)
    assert wq[:, :, Hkv:].abs().max() == 0 and wo[:, Hkv:].abs().max() == 0
    if gp > g:
        assert wq[:, :, :Hkv, g:].abs().max() == 0 and wo[:, :Hkv, g:].abs().max() == 0
    for w in (p["wk"], p["wv"]):
        assert w[:, :, Hkv:].abs().max() == 0 and w[:, :, :Hkv].abs().max() > 0
    assert wq[:, :, :Hkv, :g].abs().max() > 0 and wo[:, :Hkv, :g].abs().max() > 0


# -- a sliding window on a dense cache (repair d) -----------------------------------------

def test_window_runs_on_a_dense_cache():
    """A windowed dense model: the forward past the window equals the
    reference's, and a decode state up to the window is a dense cache
    (the engine's tokens equal the reference engine's); past the window
    the state is a ring cache of the window's slots."""
    jcfg = jreplace(jget_reduced("llama3.2-1b"), swa_window=16)
    cfg = replace(get_reduced("llama3.2-1b"), swa_window=16)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(2))
    tparams = _port(jparams)
    toks = _tokens(cfg.vocab_size, 2, 40, seed=8)
    want, _ = jforward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, impl=JIMPL,
                       dtype=jnp.float32)
    got, _ = forward(cfg, tparams, {"tokens": torch.from_numpy(toks).long()},
                     dtype=torch.float32)
    np.testing.assert_allclose(got.numpy()[..., :256], np.asarray(want)[..., :256],
                               rtol=1e-4, atol=1e-4)
    st = init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu")
    assert st["caches"]["k"].shape[2] == 16
    ring = init_decode_state(cfg, 2, 17, dtype=torch.float32, device="cpu")["caches"]
    assert ring["k"].shape == (cfg.num_layers, 2, 16, cfg.kv_heads_eff, cfg.head_dim)
    assert ring["slot_pos"].shape == (cfg.num_layers, 16)
    got, want = _engine_tokens(cfg, tparams, jcfg, jparams, max_seq=16)
    assert got == want


# -- checkpoints and configs ------------------------------------------------------------

def test_olmo_state_cross_restores(monkeypatch):
    """olmo-1b's tree, with its empty norm dicts, written by either
    package restores in the other; the manifests' treedefs agree."""
    monkeypatch.setattr(jckpt, "_CODEC", "zlib")     # the port reads zlib only
    jcfg = jget_reduced("olmo-1b")
    host = _np_tree(jinit_params(jcfg, jax.random.PRNGKey(0)))
    tstate = {"params": _port(host)}
    jstate = {"params": jax.tree.map(jnp.asarray, host)}
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        Checkpointer(d1).save(3, tstate, blocking=True)
        jckpt.Checkpointer(d2).save(3, jstate, blocking=True)
        _, from_port = jckpt.Checkpointer(d1).restore(jstate)
        _, from_ref = Checkpointer(d2).restore(tstate)
        metas = [jckpt._decompress_meta(open(os.path.join(d, "step_3",
                                                          "meta.msgpack.zlib"),
                                             "rb").read(), "zlib")
                 for d in (d1, d2)]
    assert metas[0] == metas[1]
    want = dict(leaves_with_paths(host))
    assert from_ref["params"]["blocks"]["ln1"] == {}
    for got in (from_port, from_ref):
        flat = dict(leaves_with_paths(got))
        assert sorted(flat) == sorted(f"params/{p}" for p in want)
        for p, w in want.items():
            np.testing.assert_array_equal(np.asarray(flat[f"params/{p}"]), w)


FIT_CASES = {  # arch, layers (None: all), what, refused on an 80 GB card
    "train-olmo": ("olmo-1b", None, "train", False),
    "train-smollm": ("smollm-360m", None, "train", False),
    "train-zamba2": ("zamba2-2.7b", None, "train", False),
    "train-qwen3": ("qwen3-14b", None, "train", True),
    "train-mixtral-16": ("mixtral-8x7b", 16, "train", True),
    "serve-qwen3": ("qwen3-14b", None, "serve", False),
    "serve-mixtral-16": ("mixtral-8x7b", 16, "serve", False),
    "serve-mixtral": ("mixtral-8x7b", None, "serve", True),
    "serve-grok": ("grok-1-314b", None, "serve", True),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_launchers_refuse_what_does_not_fit(case):
    """The launchers' rule on an 80 GB card: training keeps 16 bytes a
    parameter (f32 parameters, gradients, two AdamW moments), serving 2
    (bf16 weights); past the card's memory they refuse, saying why."""
    from repro_torch.device import check_fits
    from repro_torch.launch.train import train_bytes_per_param
    arch, n_layers, what, refused = FIT_CASES[case]
    cfg = get_config(arch)
    if n_layers:
        cfg = replace(cfg, num_layers=n_layers)
    per = train_bytes_per_param(torch.float32, torch.float32) if what == "train" else 2
    need = per * cfg.param_count()
    if refused:
        with pytest.raises(ValueError, match="more than the card's 80.0 GB"):
            check_fits(arch, need, 80_000_000_000)
    else:
        check_fits(arch, need, 80_000_000_000)
    check_fits(arch, need, None)                     # not a card: no check


CONVERT_CASES = {"olmo-1b": ("olmo-1b", {}),
                 "qwen3-14b-padded": ("qwen3-14b", PADS["qwen3-14b"]),
                 "smollm-360m-padded": ("smollm-360m", PADS["smollm-360m"]),
                 "mixtral-8x7b": ("mixtral-8x7b", {})}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_params_from_numpy_carries_the_tree(case):
    """``convert.params_from_numpy`` keeps every leaf (the MoE tree's
    router / gate / up / down, the padded attention) bit for bit with its
    dtype, and keeps the empty norm dicts of np_layernorm."""
    arch, fields = CONVERT_CASES[case]
    jcfg = jreplace(jget_reduced(arch), **fields)
    host = _np_tree(jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(1)))
    got = params_from_numpy(host, device="cpu")
    assert _shapes(got) == _shapes(host)
    want = dict(leaves_with_paths(host))
    for path, leaf in leaves_with_paths(got):
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    if jcfg.norm_type == "np_layernorm":
        assert got["final_norm"] == {} == got["blocks"]["ln2"]
    if jcfg.moe:
        assert sorted(got["blocks"]["ffn"]) == ["down", "gate", "router", "up"]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(jget_reduced(arch))
