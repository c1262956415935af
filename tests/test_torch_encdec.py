"""The port's encoder-decoder family (whisper-tiny, reduced) against the JAX
reference on the CPU, in f32, with the reference's parameters carried over
(``convert.params_from_numpy``) and the same numpy inputs: ``sinusoid``,
``apply_cross_attn``, ``prefill_attn``, ``encode``, the forward, the loss
and every gradient leaf, the decode state's cross K/V and ``decode_step``
token by token (the reference once through its Pallas kernels in interpret
mode), checkpoints both ways, and the engine's and launchers' refusals.

Tolerances: the sinusoid to 1e-5, and to 2e-4 over whisper's 1500
positions (one f32 ulp of an angle near 1500 rad is 1.2e-4); 1e-5 for a
single attention layer and the encoder; 1e-4 for logits (as
``test_torch_model.py``); the loss to 1e-5 relative and every gradient
leaf to 1e-4 of its largest |g| (as ``test_torch_train.py``)."""
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
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.models import kvcache as jkvcache
from repro.models import loss_fn as jloss_fn
from repro.models import model as jmodel
from repro.models.transformer import Impl as JImpl

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import OptimizerConfig, TrainConfig, get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, loss_fn)
from repro_torch.models import attention as attn
from repro_torch.models import kvcache
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tf
from repro_torch.runtime import ServingEngine, make_decode_step, make_prefill_step
from repro_torch.runtime.steps import make_train_step
from repro_torch.tree import leaves, leaves_with_paths

ARCH = "whisper-tiny"
JIMPL = JImpl(attention="chunked", remat=False)
JPALLAS = JImpl(attention="pallas", decode_attention="pallas_decode", remat=False)


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


def _batch(cfg, B, S, seed, masked=3):
    toks = _tokens(cfg.vocab_size, B, S, seed)
    labels = toks.copy()
    labels[:, :masked] = -1
    return {"tokens": toks, "labels": labels,
            "frames": _x((B, cfg.enc_ctx, cfg.d_model), seed + 100, 0.1)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def whisper():
    jcfg = jget_reduced(ARCH)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, get_reduced(ARCH), jparams, _port(jparams)


# -- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("seq,d,offset", [(24, 64, 0), (1500, 384, 0), (7, 64, 11)])
def test_sinusoid_matches_jax(seq, d, offset):
    """The angles are built in f32 as the reference's; whisper's 1500
    frames at its width included."""
    want = np.asarray(jmodel.sinusoid(seq, d, offset))
    got = tmodel.sinusoid(seq, d, offset, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 if seq < 100 else 2e-4)


def _attn_layer(jcfg, seed):
    jp = jattn.init_attn(jcfg, jax.random.PRNGKey(seed))
    return jp, _port(jp)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_apply_cross_attn_matches_jax(whisper, impl):
    jcfg, cfg, _, _ = whisper
    jp, tp = _attn_layer(jcfg, 3)
    B, S, Se = 2, 9, cfg.enc_ctx
    x, enc = _x((B, S, cfg.d_model), 1), _x((B, Se, cfg.d_model), 2)
    enc_pos = np.broadcast_to(np.arange(Se, dtype=np.int32)[None], (B, Se))
    want = jattn.apply_cross_attn(jcfg, jp, jnp.asarray(x), jnp.asarray(enc),
                                  jnp.asarray(enc_pos), impl="naive")
    got = attn.apply_cross_attn(cfg, tp, torch.from_numpy(x), torch.from_numpy(enc),
                                torch.from_numpy(enc_pos.copy()), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,use_rope", [(True, True), (False, False), (True, False)])
def test_apply_attn_modes_match_jax(whisper, causal, use_rope):
    """The encoder's mode (non-causal, no RoPE), the decoder's (causal, no
    RoPE) and the default."""
    jcfg, cfg, _, _ = whisper
    jp, tp = _attn_layer(jcfg, 4)
    B, S = 2, 13
    x = _x((B, S, cfg.d_model), 5)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    want = jattn.apply_attn(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
                            causal=causal, use_rope=use_rope, impl="naive")
    got = attn.apply_attn(cfg, tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
                          causal=causal, use_rope=use_rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_rope", [True, False])
def test_prefill_attn_matches_jax(whisper, use_rope):
    """The output and the dense cache it fills from position 0 (the rest of
    the cache stays 0), against the reference's ``prefill_attn``."""
    jcfg, cfg, _, _ = whisper
    jp, tp = _attn_layer(jcfg, 6)
    B, S, S_max = 2, 10, 16
    x = _x((B, S, cfg.d_model), 7)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    jcache = jkvcache.init_dense_cache(B, S_max, jcfg.kv_heads_eff, jcfg.head_dim,
                                       jnp.float32)
    want, wc = jattn.prefill_attn(jcfg, jp, jnp.asarray(x), jcache,
                                  positions=jnp.asarray(pos), use_rope=use_rope,
                                  impl="naive")
    cache = {k: v[0] for k, v in kvcache.init_dense_cache(
        1, B, S_max, cfg.kv_heads_eff, cfg.head_dim, torch.float32, "cpu").items()}
    got, gc = attn.prefill_attn(cfg, tp, torch.from_numpy(x), cache,
                                positions=torch.from_numpy(pos), use_rope=use_rope)
    assert gc is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(wc[k]), rtol=1e-5,
                                   atol=1e-5)
        assert not cache[k][:, S:].any()


def test_encode_matches_jax(whisper):
    jcfg, cfg, jparams, tparams = whisper
    frames = _x((2, cfg.enc_ctx, cfg.d_model), 8, 0.1)
    want = jmodel.encode(jcfg, jparams, jnp.asarray(frames), impl=JIMPL)
    got = tmodel.encode(cfg, tparams, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the model --------------------------------------------------------------------------

def test_init_params_tree_matches_reference(whisper):
    """{embed, final_norm, enc_blocks (attention blocks), blocks (decoder
    blocks: ln1, attn, ln2, cross, ln3, ffn), enc_final_norm}, leaf shapes
    equal."""
    _, cfg, jparams, _ = whisper
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    want = {p: tuple(v.shape) for p, v in leaves_with_paths(_np_tree(jparams))}
    assert {p: tuple(v.shape) for p, v in leaves_with_paths(ours)} == want
    assert sorted(ours["blocks"]) == ["attn", "cross", "ffn", "ln1", "ln2", "ln3"]
    assert sorted(ours["enc_blocks"]) == ["attn", "ffn", "ln1", "ln2"]
    assert sorted(ours["enc_final_norm"]) == ["bias", "scale"]


def test_forward_matches_jax(whisper):
    jcfg, cfg, jparams, tparams = whisper
    batch = _batch(cfg, 2, 20, seed=1)
    want, waux = jforward(jcfg, jparams, _j(batch), impl=JIMPL, dtype=jnp.float32)
    got, aux = forward(cfg, tparams, _t(batch), dtype=torch.float32)
    assert aux == {} and waux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    last, _ = forward(cfg, tparams, _t(batch), dtype=torch.float32, last_only=True)
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), rtol=1e-5, atol=1e-5)


def test_forward_through_jax_pallas_kernels(whisper):
    """The reference with its Pallas flash kernel (interpret mode) in the
    encoder, the decoder's self-attention and the cross-attention."""
    jcfg, cfg, jparams, tparams = whisper
    batch = _batch(cfg, 1, 12, seed=2)
    want, _ = jforward(jcfg, jparams, _j(batch), impl=JPALLAS, dtype=jnp.float32)
    got, _ = forward(cfg, tparams, _t(batch), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_loss_and_grads_match_jax(whisper):
    """Every gradient leaf, the encoder's and the cross-attention's
    included, against ``jax.grad``."""
    jcfg, cfg, jparams, _ = whisper
    batch = _batch(cfg, 2, 16, seed=3)
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
    assert sorted(want) == paths
    assert {"blocks/cross/wk", "blocks/cross/wq", "enc_blocks/attn/wq",
            "enc_final_norm/scale", "blocks/ln3/bias"} <= set(paths)
    for path, g in zip(paths, grads):
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_decode_state_cross_kv_matches_jax(whisper):
    """The self caches are dense and empty; the cross K/V are each layer's
    projections of the encoder output, stacked on L, as the reference's."""
    jcfg, cfg, jparams, tparams = whisper
    frames = _x((2, cfg.enc_ctx, cfg.d_model), 9, 0.1)
    jenc = jmodel.encode(jcfg, jparams, jnp.asarray(frames), impl=JIMPL)
    jst = jinit_decode_state(jcfg, jparams, 2, 16, dtype=jnp.float32, impl=JIMPL,
                             enc_out=jenc)
    enc = tmodel.encode(cfg, tparams, torch.from_numpy(frames))
    st = init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu",
                           params=tparams, enc_out=enc)
    assert st["pos"] == 0
    for part in ("self", "cross"):
        for k in ("k", "v"):
            w = np.asarray(jst["caches"][part][k])
            g = st["caches"][part][k]
            assert tuple(g.shape) == w.shape
            assert g.is_contiguous()
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    assert st["caches"]["cross"]["k"].shape == (cfg.num_layers, 2, cfg.enc_ctx,
                                                cfg.kv_heads_eff, cfg.head_dim)
    with pytest.raises(ValueError, match="enc_out"):
        init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu")


def _decode_both(whisper, jimpl, n, max_seq, per_slot=False, seed=4):
    """n tokens through both packages' decode_step from an encoded state;
    → (port logits (B, n, V), reference logits)."""
    jcfg, cfg, jparams, tparams = whisper
    B = 2
    frames = _x((B, cfg.enc_ctx, cfg.d_model), seed, 0.1)
    toks = _tokens(cfg.vocab_size, B, n, seed)
    jenc = jmodel.encode(jcfg, jparams, jnp.asarray(frames), impl=JIMPL)
    jst = jinit_decode_state(jcfg, jparams, B, max_seq, dtype=jnp.float32, impl=jimpl,
                             enc_out=jenc)
    st = init_decode_state(cfg, B, max_seq, dtype=torch.float32, device="cpu",
                           params=tparams,
                           enc_out=tmodel.encode(cfg, tparams, torch.from_numpy(frames)))
    if per_slot:
        jst["pos"] = jnp.zeros((B,), jnp.int32)
        st["pos"] = torch.zeros((B,), dtype=torch.int32)
    jstep = jax.jit(lambda p, s, t: jdecode_step(jcfg, p, s, t, impl=jimpl,
                                                 dtype=jnp.float32))
    got, want = [], []
    for t in range(n):
        jl, jst = jstep(jparams, jst, jnp.asarray(toks[:, t:t + 1]))
        lg, st = decode_step(cfg, tparams, st, torch.from_numpy(toks[:, t:t + 1]).long(),
                             dtype=torch.float32)
        want.append(np.asarray(jl)[:, 0])
        got.append(lg[:, 0].numpy())
    return np.stack(got, 1), np.stack(want, 1)


@pytest.mark.parametrize("jimpl", ["naive", "pallas"])
def test_decode_step_matches_jax_token_by_token(whisper, jimpl):
    """The self cache and the cross K/V, token by token against the
    reference's decode (naive attention, or its Pallas decode and flash
    kernels in interpret mode)."""
    impl = JImpl(attention="naive", remat=False) if jimpl == "naive" else JPALLAS
    got, want = _decode_both(whisper, impl, 10, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_decode_per_slot_positions_match_jax(whisper):
    """(B,) positions (the engine's protocol): the sinusoid of each row's
    position and per-row inserts, as the reference's."""
    got, want = _decode_both(whisper, JImpl(attention="naive", remat=False), 6, 8,
                             per_slot=True, seed=5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_decode_past_max_seq_clamps_like_jax(whisper):
    """Positions past the self cache's end clamp the insert to its last
    slot, as ``dynamic_update_slice`` does: the reference's logits."""
    got, want = _decode_both(whisper, JImpl(attention="naive", remat=False), 12, 8,
                             seed=6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_decode_matches_forward(whisper):
    """The port's decode over a prompt against its own forward's logits."""
    _, cfg, _, tparams = whisper
    batch = _t(_batch(cfg, 2, 10, seed=7))
    want, _ = forward(cfg, tparams, batch, dtype=torch.float32)
    st = init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu", params=tparams,
                           enc_out=tmodel.encode(cfg, tparams, batch["frames"]))
    for t in range(10):
        lg, st = decode_step(cfg, tparams, st, batch["tokens"][:, t:t + 1].long(),
                             dtype=torch.float32)
        np.testing.assert_allclose(lg[:, 0].numpy(), want[:, t].numpy(), rtol=1e-4,
                                   atol=1e-4)


# -- steps, engine, launchers, checkpoints ----------------------------------------------

def test_steps_carry_frames(whisper):
    """``make_prefill_step`` takes the frames to the forward; the decode
    step runs on the cross state; a train step over microbatches splits the
    frames with the tokens and lowers the loss."""
    _, cfg, jparams, _ = whisper
    tparams = _port(jparams)
    batch = _t(_batch(cfg, 4, 12, seed=8))
    pre = make_prefill_step(cfg, dtype=torch.float32)(tparams, batch)
    full, _ = forward(cfg, tparams, batch, dtype=torch.float32)
    np.testing.assert_allclose(pre.numpy(), full[:, -1:].numpy(), rtol=1e-5, atol=1e-5)
    st = init_decode_state(cfg, 4, 8, dtype=torch.float32, device="cpu", params=tparams,
                           enc_out=tmodel.encode(cfg, tparams, batch["frames"]))
    lg, st = make_decode_step(cfg, dtype=torch.float32)(tparams, st,
                                                       batch["tokens"][:, :1].long())
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 0].numpy(), rtol=1e-4, atol=1e-4)
    from repro_torch.optim.adamw import init_opt_state
    tcfg = TrainConfig(microbatch_size=2, dtype="float32",
                       optimizer=OptimizerConfig(lr=3e-3, warmup_steps=1, total_steps=4))
    step = make_train_step(cfg, tcfg)
    opt = init_opt_state(tparams)
    losses = []
    for _ in range(4):
        tparams, opt, m = step(tparams, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_engine_refuses_an_encoder_decoder(whisper):
    _, cfg, _, tparams = whisper
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(cfg, tparams, max_batch=2, max_seq=16, dtype=torch.float32,
                      device="cpu")


def test_serve_launcher_refuses_whisper(capsys):
    """``launch.serve`` passes the engine's refusal on as a usage error."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu"])
    assert "encoder-decoder" in capsys.readouterr().err


def test_train_launcher_trains_reduced_whisper(capsys):
    from repro_torch.launch import train
    train.main(["--arch", ARCH, "--device", "cpu", "--steps", "4", "--seq", "16",
                "--batch", "4", "--micro", "2"])
    out = capsys.readouterr().out
    assert "arch=whisper-tiny-smoke" in out and "steps 4" in out


def test_whisper_state_cross_restores(whisper, monkeypatch):
    """whisper's tree (encoder and decoder stacks, layernorm biases)
    written by either package restores in the other."""
    monkeypatch.setattr(jckpt, "_CODEC", "zlib")     # the port reads zlib only
    _, _, jparams, _ = whisper
    host = _np_tree(jparams)
    tstate = {"params": _port(host)}
    jstate = {"params": jax.tree.map(jnp.asarray, host)}
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        Checkpointer(d1).save(5, tstate, blocking=True)
        jckpt.Checkpointer(d2).save(5, jstate, blocking=True)
        _, from_port = jckpt.Checkpointer(d1).restore(jstate)
        _, from_ref = Checkpointer(d2).restore(tstate)
        metas = [jckpt._decompress_meta(open(os.path.join(d, "step_5",
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


def test_dec_stack_is_the_reference_tree(whisper):
    """``init_dec_stack`` stacks decoder blocks whose cross-attention has
    the self-attention's shapes."""
    _, cfg, _, _ = whisper
    p = tf.init_dec_stack(cfg, torch.Generator().manual_seed(1), 3)
    assert {k: tuple(v.shape) for k, v in p["cross"].items()} == \
        {k: tuple(v.shape) for k, v in p["attn"].items()}
    assert p["ln3"]["scale"].shape == (3, cfg.d_model)


def test_full_whisper_fits_training_on_a_card():
    from repro_torch.device import check_fits
    from repro_torch.launch.train import train_bytes_per_param
    cfg = get_config(ARCH)
    per = train_bytes_per_param(torch.float32, torch.float32)
    check_fits(ARCH, per * cfg.param_count(), 80_000_000_000)
    assert 50e6 < cfg.param_count() < 60e6


@pytest.mark.parametrize("seed,step,batch,seq", [(0, 0, 3, 16), (7, 5, 2, 40)])
def test_synthetic_batches_equal_the_reference(seed, step, batch, seq):
    """The data stream with the family's ``frames``, batched and per row,
    bit for bit the reference's."""
    from repro.data import SyntheticDataset as JSyntheticDataset
    from repro_torch.data import SyntheticDataset
    want = JSyntheticDataset(jget_reduced(ARCH), seq, seed=seed).batch(step, batch)
    ds = SyntheticDataset(get_reduced(ARCH), seq, seed=seed)
    got = ds.batch(step, batch)
    assert sorted(got) == sorted(want) and "frames" in got
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in ds.sample(step, batch - 1).items():
        np.testing.assert_array_equal(got[k][batch - 1], v, err_msg=k)


def test_config_matches_reference():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(jget_reduced(ARCH))
