"""The port's hybrid family (zamba2-2.7b: segments of mamba blocks with one
shared attention block between them) against the JAX reference on the CPU,
on reduced zamba2 with the reference's parameters carried over
(``convert.params_from_numpy``) and the same numpy batches: the forward's
logits, the loss and every gradient leaf (the shared block's summed over
its insertions), teacher-forced decode against the forward, greedy engine tokens against
the JAX engine (with slots reused), and the reset of a reused slot in the
nested decode state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models.transformer import Impl as JImpl
from repro.runtime import Request as JRequest
from repro.runtime import ServingEngine as JServingEngine

from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import (Impl, forward, init_decode_state, init_params,
                                loss_fn)
from repro_torch.runtime import Request, ServingEngine
from repro_torch.runtime.steps import make_decode_step
from repro_torch.tree import leaves, leaves_with_paths

ARCH = "zamba2-2.7b"
JCFG = jget_reduced(ARCH)
JIMPL = JImpl(attention="chunked", ssd="chunked", remat=False)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs (restored after): the
    suite runs six workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jparams = jax.jit(lambda k: jinit_params(JCFG, k))(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (B, S)) \
        .astype(np.int32)


def _batch(B, S, seed, masked=3):
    toks = _tokens(B, S, seed)
    labels = toks.copy()
    labels[:, :masked] = -1
    return {"tokens": toks, "labels": labels}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("tdtype", [torch.float32, torch.bfloat16])
def test_forward_matches_jax(params, tdtype):
    """S = 40 is ragged for the chunk of 16 and for the attention tiles. In
    f32 the logits agree to 2e-4. In bf16 the two packages round at other
    places, and on this config each side's bf16 logits sit ~0.1 from the
    f32 ones (llama3.2-1b's and mamba2's reduced configs: ~0.01): the
    port's bf16 logits are held to the reference's f32 logits within 1.5x
    the distance of the reference's own bf16 logits from them."""
    jparams, tparams = params
    toks = _tokens(2, 40, seed=1)
    V = JCFG.vocab_size

    def ref(dtype):
        out, _ = jforward(JCFG, jparams, {"tokens": jnp.asarray(toks)}, impl=JIMPL,
                          dtype=dtype)
        return np.asarray(out, np.float32)[..., :V]
    got, aux = forward(get_reduced(ARCH), tparams,
                       {"tokens": torch.from_numpy(toks).long()}, dtype=tdtype)
    assert got.dtype == torch.float32 and got.shape[:2] == (2, 40) and aux == {}
    want = ref(jnp.float32)
    got = got.numpy()[..., :V]
    if tdtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        bound = 1.5 * np.abs(ref(jnp.bfloat16) - want).max()
        assert np.abs(got - want).max() <= bound


def test_loss_and_grads_match_jax(params):
    """f32 on both sides, the reference through its chunked SSD (finite at
    the reduced config's decays). Every leaf within 1e-4 of its largest
    |g| (A_log and dt_bias, which feed the decay, 1e-3: the port's prefix
    sums are f64, the reference's f32); the shared block's gradient sums
    its two insertions on both sides."""
    jparams, tparams = params
    batch = _batch(2, 40, seed=2)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(JCFG, p, {k: jnp.asarray(v) for k, v in batch.items()},
                           impl=JIMPL, dtype=jnp.float32), has_aux=True))(jparams)
    tp = params_from_numpy(_np_tree(jparams), device="cpu")
    flat = [p.requires_grad_(True) for p in leaves(tp)]
    loss, _ = loss_fn(get_reduced(ARCH), tp,
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      impl=Impl(), dtype=torch.float32)
    grads = torch.autograd.grad(loss, flat)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(leaves_with_paths(_np_tree(jg)))
    assert any(p.startswith("shared_attn/") for p in want)
    for (path, _), g in zip(leaves_with_paths(tp), grads):
        w = want[path]
        tol = (1e-3 if path.endswith(("A_log", "dt_bias")) else 1e-4) * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol, err_msg=path)


def test_decode_matches_forward(params):
    """Teacher-forced decode reproduces the forward's logits at every
    position (the reference's ``tests/test_models.py`` check), and counts
    no launch on the CPU."""
    _, tparams = params
    cfg = get_reduced(ARCH)
    toks = torch.from_numpy(_tokens(2, 12, seed=3)).long()
    ops.LAUNCHES.reset()
    want, _ = forward(cfg, tparams, {"tokens": toks}, dtype=torch.float32)
    step = make_decode_step(cfg, dtype=torch.float32)
    st = init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, st = step(tparams, st, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)[..., :cfg.vocab_size]
    torch.testing.assert_close(got, want[..., :cfg.vocab_size], rtol=2e-4,
                               atol=2e-4)
    assert sum(ops.LAUNCHES.snapshot().values()) == 0


PROMPTS = [[5, 9, 2], [7, 7, 1, 3, 200], [11], [4, 8, 15, 16, 23, 42], [1, 2]]


def test_engine_tokens_match_jax_engine(params):
    """Five requests on two slots in f32: three are admitted to a slot
    another request has left, whose SSM states and KV caches must be
    reset."""
    jparams, tparams = params
    jeng = JServingEngine(JCFG, jparams, max_batch=2, max_seq=32,
                          impl=JImpl(attention="naive", remat=False))
    eng = ServingEngine(get_reduced(ARCH), tparams, max_batch=2, max_seq=32,
                        dtype=torch.float32, device="cpu")
    for i, p in enumerate(PROMPTS):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=4 + i))
        eng.submit(Request(rid=i, prompt=p, max_new=4 + i))
    want = {r.rid: r.generated for r in jeng.run_until_drained()}
    got = {r.rid: r.generated for r in eng.run_until_drained()}
    assert got == want
    assert eng.ticks == jeng.ticks


def test_slot_reset_zeroes_every_leaf_of_the_nested_state(params):
    """Admitting a request to slot 1 zeroes row 1 of every leaf of the
    {"mamba": {"ssd", "conv"}, "attn": {"k", "v"}} state, and no other
    row."""
    _, tparams = params
    eng = ServingEngine(get_reduced(ARCH), tparams, max_batch=2, max_seq=16,
                        dtype=torch.float32, device="cpu")
    caches = eng.state["caches"]
    assert sorted(caches) == ["attn", "mamba"]
    for leaf in leaves(caches):
        leaf.fill_(1.0)
    eng.slots[0] = Request(rid=99, prompt=[1])          # slot 0 is busy
    eng.submit(Request(rid=0, prompt=[3, 4]))
    eng._admit()
    assert eng.slots[1].rid == 0
    for path, leaf in leaves_with_paths(caches):
        assert torch.all(leaf[:, 1] == 0), path
        assert torch.all(leaf[:, 0] == 1), path


def test_init_params_tree_and_decode_state_match_reference(params):
    _, tparams = params
    cfg = get_reduced(ARCH)
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    shapes = {p: tuple(v.shape) for p, v in leaves_with_paths(ours)}
    assert shapes == {p: tuple(v.shape) for p, v in leaves_with_paths(tparams)}
    full = get_config(ARCH)
    st = init_decode_state(full, 2, 64, dtype=torch.bfloat16, device="cpu")
    assert st["caches"]["mamba"]["ssd"].shape == (54, 2, 80, 64, 64)
    assert st["caches"]["mamba"]["ssd"].dtype == torch.float32
    assert st["caches"]["mamba"]["conv"].shape == (54, 2, 3, 5248)
    assert st["caches"]["attn"]["k"].shape == (9, 2, 64, 32, 80)
    assert (full.family, full.attn_every, full.shared_attn, full.ssm.d_state,
            full.head_dim) == ("hybrid", 6, True, 64, 80)
