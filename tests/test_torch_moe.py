"""The port's MoE family (mixtral-8x7b and grok-1-314b, reduced) against the
JAX reference on the CPU, in f32, with the reference's parameters carried
over (``convert.params_from_numpy``) and the same numpy inputs.

Tolerances: the routing's dispatch (which pair lands in which slot of which
expert) exactly, its combine weights to 1e-6; ``apply_moe``'s output and aux
to 1e-5; logits to 1e-4; the loss to 1e-5 relative and every gradient leaf
to 1e-4 of its largest |g| (as ``test_torch_train.py``); greedy engine
tokens identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import replace as jreplace
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import moe as jmoe
from repro.models.transformer import Impl as JImpl
from repro.runtime import Request as JRequest
from repro.runtime import ServingEngine as JServingEngine

from repro_torch.configs import get_config, get_reduced, replace
from repro_torch.convert import params_from_numpy
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, loss_fn)
from repro_torch.models import moe
from repro_torch.runtime import Request, ServingEngine
from repro_torch.tree import leaves, leaves_with_paths

ARCHS = ["mixtral-8x7b", "grok-1-314b"]
JIMPL = JImpl(attention="chunked", remat=False)


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


def _cfgs(arch, **moe_fields):
    """The reduced config of ``arch`` in both packages, with ``moe_fields``
    replaced in its MoEConfig."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    if moe_fields:
        jcfg = jreplace(jcfg, moe=jreplace(jcfg.moe, **moe_fields))
        cfg = replace(cfg, moe=replace(cfg.moe, **moe_fields))
    return jcfg, cfg


def _layer(jcfg, seed=0):
    """One MoE FFN's parameters from the reference's ``init_moe``."""
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    return jp, _port(jp)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _dense(route, T, E):
    """The port's routing as the reference's (T, E, C) dispatch and combine."""
    C = route["capacity"]
    disp = np.zeros((T, E, C), np.float32)
    comb = np.zeros((T, E, C), np.float32)
    e, s = route["expert"].numpy(), route["slot"].numpy()
    keep, w = route["keep"].numpy(), route["weight"].detach().numpy()
    for t, j in zip(*np.nonzero(keep)):
        disp[t, e[t, j], s[t, j]] += 1.0
        comb[t, e[t, j], s[t, j]] += w[t, j]
    return disp, comb


ROUTE_CASES = {
    # capacity factor, batch rows, tokens a row, tie
    "loose": (8.0, 2, 32, False),
    "published": (1.25, 2, 32, False),
    "tight_second_choices_drop": (0.5, 2, 32, False),
    "two_prompts_compete": (0.5, 2, 24, False),
    "tied_experts": (1.0, 2, 32, True),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch, case):
    cf, B, S, tie = ROUTE_CASES[case]
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _layer(jcfg)
    if tie:      # experts 1 and 2 get equal logits: the lower one ranks first
        r = np.asarray(jp["router"]).copy()
        r[:, 2] = r[:, 1]
        jp = dict(jp, router=jnp.asarray(r))
        tp = dict(tp, router=torch.from_numpy(r))
    xf = _x((B * S, cfg.d_model), seed=1)
    jd, jc, jaux = jmoe._route(jcfg, jp, jnp.asarray(xf))
    route, aux = moe._route(cfg, tp, torch.from_numpy(xf))
    E = cfg.moe.num_experts
    assert route["capacity"] == jd.shape[2] == moe.capacity(cfg, B * S)
    disp, comb = _dense(route, B * S, E)
    assert np.array_equal(disp, np.asarray(jd))
    np.testing.assert_allclose(comb, np.asarray(jc), rtol=0, atol=1e-6)
    for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    keep = route["keep"].numpy()
    if case == "loose":
        assert keep.all()
    if case == "tight_second_choices_drop":
        assert (keep[:, 0] & ~keep[:, 1]).any()
    if case == "two_prompts_compete":
        # the second prompt's tokens queue after the first's: some of its
        # first choices are dropped, none of the first prompt's are
        assert keep[:S, 0].all() and not keep[S:, 0].all()
    if tie:
        e = route["expert"].numpy()
        tied = np.isin(e[:, 0], (1, 2)) & np.isin(e[:, 1], (1, 2))
        assert tied.any() and (e[tied, 0] == 1).all()


@pytest.mark.parametrize("group_size", [None, 16])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, cf, group_size):
    """Grouped (4 groups of 16 tokens: aux is the groups' mean) and
    ungrouped, at the published capacity factor and at a tight one."""
    jcfg, cfg = _cfgs(arch, capacity_factor=cf, group_size=group_size)
    jp, tp = _layer(jcfg, seed=2)
    x = _x((2, 32, cfg.d_model), seed=3)
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    y, aux = moe.apply_moe(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if cf == 0.5:
        assert aux["moe_drop_frac"].item() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_never_drops(arch):
    """S == 1: the capacity covers every token of the batch even at a
    capacity factor that drops in a prefill, as the reference's."""
    jcfg, cfg = _cfgs(arch, capacity_factor=0.1)
    jp, tp = _layer(jcfg, seed=4)
    x = _x((8, 1, cfg.d_model), seed=5)
    y, aux = moe.apply_moe(cfg, tp, torch.from_numpy(x))
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x))
    assert aux["moe_drop_frac"].item() == 0.0 == float(jaux["moe_drop_frac"])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    _, prefill_aux = moe.apply_moe(cfg, tp, torch.from_numpy(x.reshape(1, 8, -1)))
    assert prefill_aux["moe_drop_frac"].item() > 0


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jget_reduced(arch)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    return arch, jcfg, jparams, _port(jparams)


def _batch(vocab, B, S, seed, masked=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[:, :masked] = -1
    return {"tokens": toks, "labels": labels}


def test_forward_matches_jax(model):
    """S = 40 passes mixtral's reduced window of 32."""
    arch, jcfg, jparams, tparams = model
    toks = _batch(jcfg.vocab_size, 2, 40, seed=1)["tokens"]
    jl, jaux = jforward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, impl=JIMPL,
                        dtype=jnp.float32)
    got, aux = forward(get_reduced(arch), tparams,
                       {"tokens": torch.from_numpy(toks).long()}, dtype=torch.float32)
    V = jcfg.vocab_size
    np.testing.assert_allclose(got.numpy()[..., :V], np.asarray(jl)[..., :V],
                               rtol=1e-4, atol=1e-4)
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_loss_and_grads_match_jax(model):
    """The loss with both aux terms and every gradient leaf, the router's
    included (its gradient flows through the top-k weights and the aux
    losses)."""
    arch, jcfg, jparams, _ = model
    batch = _batch(jcfg.vocab_size, 2, 40, seed=2)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                           impl=JIMPL, dtype=jnp.float32), has_aux=True))(jparams)
    tp = _port(jparams)
    flat = [p.requires_grad_(True) for p in leaves(tp)]
    loss, metrics = loss_fn(get_reduced(arch), tp,
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            dtype=torch.float32)
    grads = torch.autograd.grad(loss, flat)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert loss.item() == pytest.approx(metrics["ce"].item() + metrics["moe_lb_loss"].item()
                                        + metrics["moe_z_loss"].item(), rel=1e-6)
    want = dict(leaves_with_paths(_np_tree(jg)))
    assert any(p.endswith("ffn/router") for p in want)
    for (path, _), g in zip(leaves_with_paths(tp), grads):
        w = want[path]
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_decode_matches_forward(model):
    """Teacher-forced decode reproduces the forward at every position once
    the capacity is loose enough that the forward drops nothing (the
    reference's ``tests/test_models.py`` check)."""
    arch, _, _, tparams = model
    cfg = get_reduced(arch)
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
    toks = torch.from_numpy(_batch(cfg.vocab_size, 2, 12, seed=3)["tokens"]).long()
    want, aux = forward(cfg, tparams, {"tokens": toks}, dtype=torch.float32)
    assert aux["moe_drop_frac"].item() == 0.0
    st = init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, st = decode_step(cfg, tparams, st, toks[:, t:t + 1], dtype=torch.float32)
        outs.append(lg[:, 0])
    V = cfg.vocab_size
    torch.testing.assert_close(torch.stack(outs, 1)[..., :V], want[..., :V],
                               rtol=2e-4, atol=2e-4)


PROMPTS = [[5, 9, 2], [7, 7, 1, 3, 200], [11], [4, 8, 15, 16, 23, 42], [1, 2]]


def test_engine_tokens_match_jax_engine(model):
    """Five requests on two slots in f32 (max_seq 32: within mixtral's
    reduced window, a dense cache)."""
    arch, jcfg, jparams, tparams = model
    jeng = JServingEngine(jcfg, jparams, max_batch=2, max_seq=32,
                          impl=JImpl(attention="naive", remat=False))
    eng = ServingEngine(get_reduced(arch), tparams, max_batch=2, max_seq=32,
                        dtype=torch.float32, device="cpu")
    for i, p in enumerate(PROMPTS):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=4 + i))
        eng.submit(Request(rid=i, prompt=p, max_new=4 + i))
    want = {r.rid: r.generated for r in jeng.run_until_drained()}
    got = {r.rid: r.generated for r in eng.run_until_drained()}
    assert got == want
    assert eng.ticks == jeng.ticks


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """The same leaf paths and shapes as the reference's ``init_params``
    (router (L, D, E), gate / up (L, E, D, F), down (L, E, F, D))."""
    jcfg = jget_reduced(arch)
    shapes = jax.eval_shape(lambda k: jinit_params(jcfg, k), jax.random.PRNGKey(0))
    want = {p: tuple(v.shape) for p, v in leaves_with_paths(
        jax.tree.map(lambda s: np.empty(s.shape, np.float32), shapes))}
    ours = init_params(get_reduced(arch), torch.Generator().manual_seed(0))
    assert {p: tuple(v.shape) for p, v in leaves_with_paths(ours)} == want
    m = jcfg.moe
    L, D, F, E = jcfg.num_layers, jcfg.d_model, jcfg.d_ff, m.num_experts
    assert want["blocks/ffn/gate"] == (L, E, D, F)
    assert want["blocks/ffn/down"] == (L, E, F, D)


def test_decode_state_refuses_a_ring_cache():
    """A window needs no ring cache while max_seq fits in it; past it the
    state is a ring of the window's slots (mixtral's published 4096, at
    one layer here), and the engine refuses it."""
    cfg = get_reduced("mixtral-8x7b")
    st = init_decode_state(cfg, 2, cfg.swa_window, dtype=torch.float32, device="cpu")
    assert st["caches"]["k"].shape == (2, 2, cfg.swa_window, 2, 16)
    ring = init_decode_state(cfg, 2, cfg.swa_window + 1, dtype=torch.float32,
                             device="cpu")["caches"]
    assert ring["k"].shape == ring["v"].shape == (2, 2, cfg.swa_window, 2, 16)
    assert ring["slot_pos"].shape == (2, cfg.swa_window)
    assert (ring["slot_pos"] == -1).all()
    full = replace(get_config("mixtral-8x7b"), num_layers=1)
    ring = init_decode_state(full, 1, 8192, dtype=torch.bfloat16, device="cpu")["caches"]
    assert ring["k"].shape == (1, 1, 4096, 8, 128) and ring["k"].dtype == torch.bfloat16
    assert ring["slot_pos"].shape == (1, 4096) and ring["slot_pos"].dtype == torch.int32
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="ring caches"):
        ServingEngine(cfg, params, max_batch=2, max_seq=cfg.swa_window + 1,
                      dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(jget_reduced(arch))
