"""The port's training math against the JAX reference on the CPU, in f32,
with the reference's parameters carried over (``convert.params_from_numpy``)
and the same numpy batches: the loss and every gradient leaf of one batch
(reduced llama3.2-1b and mamba2-1.3b), one AdamW update (f32 and bf16
moments), and one train step of 2 microbatches; plus the reference's own
optimizer tests (``tests/test_optim.py``) ported."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jget_reduced
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models.transformer import Impl as JImpl
from repro.optim import adamw_update as jadamw_update
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime.steps import make_train_step as jmake_train_step

from repro_torch.configs import OptimizerConfig, TrainConfig, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import Impl, init_decode_state, init_params, loss_fn
from repro_torch.optim import (adamw_update, clip_by_global_norm, cosine_lr,
                               global_norm, init_opt_state)
from repro_torch.runtime.steps import (make_decode_step, make_prefill_step,
                                       make_train_step)
from repro_torch.tree import leaves, leaves_with_paths, map_tree


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this module runs (restored after): the
    suite runs six workers on the same cores, beside timing-sensitive
    gateway tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# (arch, reference Impl, loss tolerance, gradient tolerance relative to the
# leaf's largest |g|): f32 on both sides; the two libraries sum in another
# order, and the SSD's f64 prefix sums in the port differ from the
# reference's f32 ones, so mamba2's leaves that feed the decay (A_log,
# dt_bias) get 1e-3.
LOSS_CASES = [
    ("llama3.2-1b", JImpl(attention="chunked", remat=False), 1e-5, {"*": 1e-4}),
    ("mamba2-1.3b", JImpl(ssd="ref", remat=False), 1e-5,
     {"*": 1e-4, "A_log": 1e-3, "dt_bias": 1e-3}),
    ("mamba2-1.3b", JImpl(ssd="chunked", remat=False), 1e-5,
     {"*": 1e-4, "A_log": 1e-3, "dt_bias": 1e-3}),
]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, B, S, seed, masked=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[:, :masked] = -1                 # e.g. prompt positions
    return {"tokens": toks, "labels": labels}


def _port(tree_np):
    return params_from_numpy(tree_np, device="cpu")


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaf_tol(path, tols):
    return next((t for key, t in tols.items() if key != "*" and path.endswith(key)),
                tols["*"])


@pytest.mark.parametrize("arch,jimpl,loss_tol,grad_tols", LOSS_CASES,
                         ids=["llama-chunked", "mamba-ref", "mamba-chunked"])
def test_loss_and_grads_match_jax(arch, jimpl, loss_tol, grad_tols):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg, 2, 40, seed=1)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                           impl=jimpl, dtype=jnp.float32), has_aux=True)(jparams)
    jl = float(jl)
    assert np.isfinite(jl) and all(np.isfinite(np.asarray(x)).all()
                                   for x in jax.tree.leaves(jg))
    params = _port(_np_tree(jparams))
    flat = [p.requires_grad_(True) for _, p in leaves_with_paths(params)]
    loss, metrics = loss_fn(cfg, params, _tbatch(batch), impl=Impl(),
                            dtype=torch.float32)
    grads = torch.autograd.grad(loss, flat)
    assert abs(loss.item() - jl) <= loss_tol * abs(jl)
    assert metrics["ce"].item() == loss.item() == metrics["loss"].item()
    want = dict(leaves_with_paths(_np_tree(jg)))
    for (path, _), g in zip(leaves_with_paths(params), grads):
        w = want[path]
        tol = _leaf_tol(path, grad_tols) * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol, err_msg=path)


def test_loss_masks_labels_like_the_reference():
    """All labels -1 but one: the mean runs over that one target."""
    jcfg, cfg = jget_reduced("llama3.2-1b"), get_reduced("llama3.2-1b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(2))
    batch = _batch(cfg, 1, 12, seed=3, masked=11)
    jl, _ = jloss_fn(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                     impl=JImpl(attention="chunked", remat=False), dtype=jnp.float32)
    with torch.no_grad():
        loss, _ = loss_fn(cfg, _port(_np_tree(jparams)), _tbatch(batch),
                          dtype=torch.float32)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))


def _random_grads(tree_np, seed):
    rng = np.random.default_rng(seed)
    return {k: _random_grads(v, seed + i) if isinstance(v, dict)
            else rng.standard_normal(v.shape).astype(np.float32)
            for i, (k, v) in enumerate(tree_np.items())}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_matches_jax(moments):
    """Two updates (moments and bias corrections both in play), with the
    global norm clipped on the second; weight decay 0.1 on every leaf with
    more than one dimension, the stacked (L, D) norm scales included, as
    the reference's ``p.ndim > 1`` decides."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[moments]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moments]
    cfg = JOptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=30.0)
    tcfg = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=30.0)
    p_np = _np_tree(jinit_params(jget_reduced("llama3.2-1b"), jax.random.PRNGKey(4)))
    jp, jst = jax.tree.map(jnp.asarray, p_np), jinit_opt_state(p_np, jdt)
    tp = _port(p_np)
    tst = init_opt_state(tp, tdt)
    for i, scale in enumerate((0.01, 3.0)):
        g_np = jax.tree.map(lambda x: x * scale, _random_grads(p_np, 10 + i))
        jp, jst, jm = jadamw_update(jp, jax.tree.map(jnp.asarray, g_np), jst, cfg)
        tp, tst, tm = adamw_update(tp, _port(g_np), tst, tcfg)
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        assert abs(tm["lr"] - float(jm["lr"])) <= 1e-7 * float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
    mtol = 1e-6 if moments == "float32" else 8e-3       # one bf16 rounding
    for name, tree_t, tree_j, tol in (("params", tp, jp, 1e-6), ("m", tst["m"], jst["m"], mtol),
                                      ("v", tst["v"], jst["v"], mtol)):
        want = dict(leaves_with_paths(_np_tree(tree_j)))
        for path, t in leaves_with_paths(tree_t):
            assert t.dtype == (torch.float32 if name == "params" else tdt)
            w = np.asarray(want[path], dtype=np.float32)
            np.testing.assert_allclose(t.float().numpy(), w, rtol=tol,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"{name}/{path}")


def test_weight_decay_follows_ndim_like_the_reference():
    """Zero gradients: the stacked (L, D) norm scales decay (2-D), the final
    norm's (D,) scale does not."""
    params = _port(_np_tree(jinit_params(jget_reduced("llama3.2-1b"),
                                         jax.random.PRNGKey(5))))
    zero = map_tree(torch.zeros_like, params)
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=10, weight_decay=1.0,
                          grad_clip=1e9)
    params, _, _ = adamw_update(params, zero, init_opt_state(params), cfg)
    assert float(params["blocks"]["ln1"]["scale"].max()) < 1.0
    assert float((params["final_norm"]["scale"] - 1.0).abs().max()) < 1e-6


def test_train_step_matches_jax():
    """One step over 4 rows in microbatches of 2: loss, lr, grad norm and
    every parameter after the update, against the reference (dp=None).
    Adam's eps is 1e-3 here: its first step divides each gradient by its
    own magnitude, which at the default 1e-8 turns f32 rounding noise of a
    near-zero gradient into an update of ±lr; with eps above the noise the
    parameters follow the gradients smoothly (the update rule itself is
    held at the default eps by test_adamw_matches_jax)."""
    jcfg, cfg = jget_reduced("llama3.2-1b"), get_reduced("llama3.2-1b")
    jtc = JTrainConfig(microbatch_size=2, dtype="float32",
                       optimizer=JOptimizerConfig(lr=1e-2, warmup_steps=1,
                                                  total_steps=10, eps=1e-3))
    ttc = TrainConfig(microbatch_size=2, dtype="float32",
                      optimizer=OptimizerConfig(lr=1e-2, warmup_steps=1,
                                                total_steps=10, eps=1e-3))
    jparams = jinit_params(jcfg, jax.random.PRNGKey(6))
    p_np = _np_tree(jparams)
    batch = _batch(cfg, 4, 24, seed=7, masked=2)
    jstep = jmake_train_step(jcfg, jtc, JImpl(attention="chunked", remat=False), dp=None)
    jp, _, jm = jstep(jparams, jinit_opt_state(jparams),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _port(p_np)
    tp, tst, tm = make_train_step(cfg, ttc)(tp, init_opt_state(tp), _tbatch(batch))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    assert abs(tm["lr"] - float(jm["lr"])) <= 1e-7
    want = dict(leaves_with_paths(_np_tree(jp)))
    for path, t in leaves_with_paths(tp):
        w = want[path]
        # each weight moves by at most ~lr = 1e-2; 1e-4 of that
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=0, atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("found", [False, True])
def test_train_step_leaves_requires_grad_as_found(found):
    """The step differentiates the parameters and then puts each leaf's
    ``requires_grad`` back as it found it, so a trained state that is
    served later builds no autograd graph."""
    cfg = get_reduced("llama3.2-1b")
    tcfg = TrainConfig(microbatch_size=2, dtype="float32")
    tp = init_params(cfg, torch.Generator().manual_seed(2))
    for p in leaves(tp):
        p.requires_grad_(found)
    before = [p.detach().clone() for p in leaves(tp)]
    tp, _, _ = make_train_step(cfg, tcfg)(tp, init_opt_state(tp),
                                          _tbatch(_batch(cfg, 4, 16, seed=3)))
    assert all(p.requires_grad == found for p in leaves(tp))
    assert any(not torch.equal(p, b) for p, b in zip(leaves(tp), before))


def test_train_step_refuses_a_batch_that_does_not_split():
    """5 rows do not split into microbatches of 2: the reference's reshape
    raises, and so does the port rather than drop the last row."""
    jcfg, cfg = jget_reduced("llama3.2-1b"), get_reduced("llama3.2-1b")
    batch = _batch(cfg, 5, 16, seed=4)
    jstep = jmake_train_step(jcfg, JTrainConfig(microbatch_size=2, dtype="float32"),
                             JImpl(attention="chunked", remat=False), dp=None)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        jstep(jparams, jinit_opt_state(jparams),
              {k: jnp.asarray(v) for k, v in batch.items()})
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(cfg, TrainConfig(microbatch_size=2, dtype="float32"))(
            tp, init_opt_state(tp), _tbatch(batch))


def test_serving_steps_build_no_graph():
    """Prefill and decode run under no_grad: parameters that require grad
    (a state in the middle of training) give outputs without a grad_fn."""
    cfg = get_reduced("llama3.2-1b")
    tp = init_params(cfg, torch.Generator().manual_seed(1))
    for p in leaves(tp):
        p.requires_grad_(True)
    toks = torch.from_numpy(_batch(cfg, 2, 8, seed=5)["tokens"])
    logits = make_prefill_step(cfg, dtype=torch.float32)(tp, {"tokens": toks})
    assert logits.grad_fn is None and not logits.requires_grad
    state = init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu")
    logits, _ = make_decode_step(cfg, dtype=torch.float32)(tp, state, toks[:, :1])
    assert logits.grad_fn is None and not logits.requires_grad


# -- the reference's optimizer tests, ported ---------------------------------

def test_adamw_converges_quadratic():
    p = {"w": torch.tensor([3.0, -2.0]), "b": torch.ones((2, 2))}
    st = init_opt_state(p)
    cfg = OptimizerConfig(lr=0.1, warmup_steps=5, total_steps=200,
                          weight_decay=0.0, grad_clip=10.0)
    for _ in range(200):
        g = {k: 2 * v for k, v in p.items()}
        p, st, _ = adamw_update(p, g, st, cfg)
    assert all(float(x.abs().max()) < 0.05 for x in p.values())
    assert int(st["step"]) == 200


def test_cosine_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert cosine_lr(0, cfg) == 0.0
    assert abs(cosine_lr(10, cfg) - 1.0) < 1e-6
    assert abs(cosine_lr(100, cfg) - 0.1) < 1e-6
    assert cosine_lr(55, cfg) > 0.1


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 20.0) < 1e-4
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-4
    g2 = {"a": torch.full((4,), 0.01)}
    same, _ = clip_by_global_norm(g2, 1.0)
    torch.testing.assert_close(same["a"], g2["a"])


def test_bf16_moment_dtype():
    p = {"w": torch.ones((4, 4))}
    st = init_opt_state(p, torch.bfloat16)
    assert st["m"]["w"].dtype == torch.bfloat16
    cfg = OptimizerConfig(lr=0.01, warmup_steps=0, total_steps=10)
    p2, st2, _ = adamw_update(p, {"w": torch.ones((4, 4))}, st, cfg)
    assert st2["m"]["w"].dtype == torch.bfloat16
    assert p2["w"].dtype == torch.float32
