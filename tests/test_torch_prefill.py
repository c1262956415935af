"""The port's full-sequence forward and prefill step against the JAX
reference on reduced llama3.2-1b and mamba2-1.3b, with the same parameters
(``repro.models.init_params`` carried over by ``convert.params_from_numpy``)
and the same tokens: logits at 2e-4 in f32 and 2e-2 in bf16 (the JAX
forward runs its Pallas kernels in interpret mode); decode against forward
within the port; and the mamba2 serving engine's greedy tokens against the
JAX engine's, with slots reused by later requests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models.transformer import Impl as JImpl
from repro.runtime import Request as JRequest
from repro.runtime import ServingEngine as JServingEngine
from repro.runtime.steps import make_prefill_step as jmake_prefill_step

from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import Impl, forward, init_decode_state, init_params
from repro_torch.runtime import Request, ServingEngine
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

ARCHS = ["llama3.2-1b", "mamba2-1.3b"]
JIMPL = JImpl(attention="pallas", ssd="pallas", remat=False)
DTYPES = [(torch.float32, jnp.float32, 2e-4), (torch.bfloat16, jnp.bfloat16, 2e-2)]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jget_reduced(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return arch, jcfg, jparams, get_reduced(arch), tparams


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)


def _close(got: torch.Tensor, want, vocab, tol):
    np.testing.assert_allclose(got.float().numpy()[..., :vocab],
                               np.asarray(want)[..., :vocab], rtol=tol, atol=tol)


@pytest.mark.parametrize("tdtype,jdtype,tol", DTYPES)
def test_forward_matches_jax(model, tdtype, jdtype, tol):
    """S = 40 is ragged for both the flash tiles and mamba2's chunk of 16."""
    _, jcfg, jparams, cfg, tparams = model
    toks = _tokens(cfg, 2, 40, seed=1)
    want, _ = jforward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, impl=JIMPL,
                       dtype=jdtype)
    got, aux = forward(cfg, tparams, {"tokens": torch.from_numpy(toks).long()},
                       dtype=tdtype)
    assert got.dtype == torch.float32 and got.shape == want.shape and aux == {}
    _close(got, want, cfg.vocab_size, tol)


@pytest.mark.parametrize("tdtype,jdtype,tol", DTYPES)
def test_prefill_step_matches_jax(model, tdtype, jdtype, tol):
    _, jcfg, jparams, cfg, tparams = model
    toks = _tokens(cfg, 3, 24, seed=2)
    want = jmake_prefill_step(jcfg, JIMPL, dtype=jdtype)(
        jparams, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(cfg, dtype=tdtype)(
        tparams, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (3, 1, want.shape[-1])
    _close(got, want, cfg.vocab_size, tol)


def test_decode_matches_forward(model):
    """Teacher-forced decode reproduces the full-sequence logits at every
    position (the port of ``tests/test_models.py``'s check)."""
    _, _, _, cfg, tparams = model
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=3)).long()
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


def test_kernel_and_plain_impls_agree_on_cpu(model):
    _, _, _, cfg, tparams = model
    toks = torch.from_numpy(_tokens(cfg, 2, 20, seed=4)).long()
    ops.LAUNCHES.reset()
    a, _ = forward(cfg, tparams, {"tokens": toks}, dtype=torch.float32)
    b, _ = forward(cfg, tparams, {"tokens": toks}, dtype=torch.float32,
                   impl=Impl(attention="plain", ssd="plain"))
    assert torch.equal(a, b)
    assert sum(ops.LAUNCHES.snapshot().values()) == 0
    with pytest.raises(ValueError):
        Impl(ssd="chunked")


# -- mamba2 behind the serving engine -----------------------------------------

MCFG = jget_reduced("mamba2-1.3b")


@pytest.fixture(scope="module")
def mamba():
    jparams = jinit_params(MCFG, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


PROMPTS = [[5, 9, 2], [7, 7, 1, 3, 200], [11], [4, 8, 15, 16, 23, 42], [1, 2]]


def test_mamba2_engine_matches_jax_engine(mamba):
    """Five requests on two slots: three are admitted to a slot another
    request has left, whose SSM state must be reset."""
    jparams, tparams = mamba
    jeng = JServingEngine(MCFG, jparams, max_batch=2, max_seq=32,
                          impl=JImpl(remat=False))
    eng = ServingEngine(get_reduced("mamba2-1.3b"), tparams, max_batch=2,
                        max_seq=32, dtype=torch.float32, device="cpu")
    for i, p in enumerate(PROMPTS):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=4 + i))
        eng.submit(Request(rid=i, prompt=p, max_new=4 + i))
    want = {r.rid: r.generated for r in jeng.run_until_drained()}
    got = {r.rid: r.generated for r in eng.run_until_drained()}
    assert got == want
    assert all(len(got[i]) == 4 + i for i in range(len(PROMPTS)))
    assert eng.ticks == jeng.ticks


def test_mamba2_reused_slot_equals_a_fresh_engine(mamba):
    """A request served in a reused slot gives the tokens it gives alone."""
    _, tparams = mamba
    cfg = get_reduced("mamba2-1.3b")
    shared = ServingEngine(cfg, tparams, max_batch=1, max_seq=32,
                           dtype=torch.float32, device="cpu")
    for i, p in enumerate(PROMPTS[:3]):
        shared.submit(Request(rid=i, prompt=p, max_new=5))
    got = {r.rid: r.generated for r in shared.run_until_drained()}
    for i, p in enumerate(PROMPTS[:3]):
        alone = ServingEngine(cfg, tparams, max_batch=1, max_seq=32,
                              dtype=torch.float32, device="cpu")
        alone.submit(Request(rid=i, prompt=p, max_new=5))
        assert alone.run_until_drained()[0].generated == got[i]


def test_mamba2_decode_state_layout():
    cfg = get_config("mamba2-1.3b")
    st = init_decode_state(cfg, 2, 64, dtype=torch.bfloat16, device="cpu")
    assert st["caches"]["ssd"].shape == (48, 2, 64, 64, 128)
    assert st["caches"]["ssd"].dtype == torch.float32
    assert st["caches"]["conv"].shape == (48, 2, 3, 4352)
    assert st["caches"]["conv"].dtype == torch.bfloat16


def test_mamba2_init_params_tree_matches_reference(mamba):
    _, tparams = mamba
    cfg = get_reduced("mamba2-1.3b")
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    assert _shapes(ours) == _shapes(tparams)
    m = ours["blocks"]["mamba"]
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert dt.min() >= cfg.ssm.dt_min * 0.999 and dt.max() <= cfg.ssm.dt_max * 1.001
    assert torch.equal(m["A_log"][1], torch.log(torch.arange(1.0, cfg.ssm_heads + 1)))
    bf = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert bf["blocks"]["mamba"]["in_proj"].dtype == torch.bfloat16
    assert bf["blocks"]["mamba"]["A_log"].dtype == torch.float32


def test_full_config_is_mamba2_1p3b():
    cfg = get_config("mamba2-1.3b")
    s = cfg.ssm
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            s.head_dim, s.d_state, s.n_groups, s.chunk_size, cfg.vocab_size,
            cfg.tie_embeddings) == ("ssm", 48, 2048, 4096, 64, 64, 128, 1, 128,
                                    50280, True)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + k + "/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out
