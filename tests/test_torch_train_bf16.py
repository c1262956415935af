"""bf16 training state in the port against the JAX reference on the CPU:
AdamW over bf16 parameters and bf16 moments (the reference's
``init_opt_state(params, bfloat16)``, as its dry run trains grok-1-314b),
the train step of one microbatch that keeps its gradients in the
parameters' dtype, AdamW run over pieces of each leaf, a reduced grok
``Trainer`` with bf16 state (and its restart from a bf16 checkpoint),
checkpoints with bf16 leaves crossed both ways with the reference's
``Checkpointer``, and ``launch.train``'s dtype tables and refusals."""
import importlib.util
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.checkpointer as jckpt
from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jget_reduced
from repro.models import init_params as jinit_params
from repro.models.transformer import Impl as JImpl
from repro.optim import adamw_update as jadamw_update
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime.steps import make_train_step as jmake_train_step

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs import (OptimizerConfig, TrainConfig, get_config,
                                 get_reduced, replace)
from repro_torch.launch import train as train_launcher
from repro_torch.models import loss_fn
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import adamw_update, global_norm, init_opt_state
from repro_torch.runtime import FailureInjector, Trainer
from repro_torch.runtime.steps import make_train_step
from repro_torch.tree import leaves, leaves_with_paths, map_tree, unflatten_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bf16 leaf (torch tensor, JAX or numpy
    bfloat16 array, or the ``|V2`` array an npz gives back)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _torch_bf16(tree_np):
    """A numpy tree of bfloat16 (or f32) arrays → torch bf16 tensors with
    the same bits (a bf16 value widens to f32 exactly)."""
    return map_tree(lambda x: torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16),
                    tree_np)


def _bf16_params(arch, seed):
    """The reference's init of a reduced model cast to bf16 on both sides
    (one rounding, to nearest even, in each library)."""
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                           jinit_params(jget_reduced(arch), jax.random.PRNGKey(seed)))
    return jparams, _torch_bf16(_np_tree(jparams))


def _random_grads(tree_np, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32), tree_np)


def _close(got, want, tol, what):
    """|got - want| <= tol·(|want| + max|want|), both widened to f32."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max(), err_msg=what)


# -- AdamW --------------------------------------------------------------------

def test_adamw_bf16_state_matches_reference_over_5_steps():
    """bf16 parameters, bf16 gradients and bf16 moments on both sides, five
    updates (the clip binding on the last two), at the reference's bf16
    tolerance of 2e-2; each side keeps its dtypes."""
    cfg = JOptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=30.0)
    tcfg = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=30.0)
    jp, tp = _bf16_params("grok-1-314b", 4)
    jst, tst = jinit_opt_state(jp, jnp.bfloat16), init_opt_state(tp, torch.bfloat16)
    for i, scale in enumerate((0.01, 0.1, 1.0, 3.0, 3.0)):
        g_np = _random_grads(_np_tree(jp), 10 + i, scale)
        jg = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), g_np)
        jp, jst, jm = jadamw_update(jp, jg, jst, cfg)
        tp, tst, tm = adamw_update(tp, _torch_bf16(_np_tree(jg)), tst, tcfg)
        assert int(tst["step"]) == int(jst["step"]) == i + 1
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
    for name, tree_t, tree_j in (("params", tp, jp), ("m", tst["m"], jst["m"]),
                                 ("v", tst["v"], jst["v"])):
        want = dict(leaves_with_paths(_np_tree(tree_j)))
        for path, t in leaves_with_paths(tree_t):
            assert t.dtype == torch.bfloat16 and want[path].dtype == jnp.bfloat16
            _close(t.float().numpy(), want[path], 2e-2, f"{name}/{path}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliced_adamw_equals_unsliced_bit_for_bit(dtype, monkeypatch):
    """Three updates over pieces of 7 elements (every leaf cut, most off
    its rows) and over whole leaves: parameters and moments equal bit for
    bit, in f32 and in bf16 state. The clip does not bind (its scale is 1
    both ways): the norm sums other pieces in each run, so it agrees to
    f32 rounding only (test_global_norm_sums_pieces)."""
    tdt = getattr(torch, dtype)
    _, base = _bf16_params("grok-1-314b", 5)
    base = map_tree(lambda t: t.to(tdt), base)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=1e9)
    runs = []
    for piece in (7, max(t.numel() for t in leaves(base))):
        monkeypatch.setattr(tadamw, "SLICE_ELEMS", piece)
        p = map_tree(torch.clone, base)
        st = init_opt_state(p, tdt)
        norms = []
        for i in range(3):
            g = map_tree(lambda t: t.to(tdt), _torch_bf16(_random_grads(
                map_tree(lambda t: t.float().numpy(), base), 20 + i, 0.5)))
            p, st, m = adamw_update(p, g, st, cfg)
            norms.append(float(m["grad_norm"]))
        runs.append((p, st, norms))
    (p1, s1, n1), (p2, s2, n2) = runs
    assert all(0 < b < cfg.grad_clip and abs(a - b) <= 1e-6 * b for a, b in zip(n1, n2))
    for tree1, tree2 in ((p1, p2), (s1["m"], s2["m"]), (s1["v"], s2["v"])):
        for (path, a), b in zip(leaves_with_paths(tree1), leaves(tree2)):
            assert a.dtype == tdt and torch.equal(a, b), path


def test_global_norm_sums_pieces(monkeypatch):
    """With pieces of 16 elements the norm still is the f32 sum of squares
    of every leaf, bf16 leaves widened (against f64)."""
    _, tp = _bf16_params("llama3.2-1b", 6)
    want = np.sqrt(sum(np.sum(t.double().numpy() ** 2) for t in leaves(tp)))
    whole = float(global_norm(tp))
    monkeypatch.setattr(tadamw, "SLICE_ELEMS", 16)
    pieces = float(global_norm(tp))
    assert abs(pieces - want) <= 1e-6 * want and abs(whole - want) <= 1e-6 * want


# -- the train step -----------------------------------------------------------

def _batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[:, :2] = -1
    return {"tokens": toks, "labels": labels}


TCFG = dict(microbatch_size=4, dtype="float32")
OCFG = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "grok-1-314b"])
def test_one_microbatch_bf16_step_matches_reference(arch):
    """One step of 4 rows in one microbatch over bf16 parameters and bf16
    moments, f32 compute, against the reference's ``make_train_step``
    (which sums the microbatch's bf16 gradients into f32): the loss, the
    grad norm and every updated bf16 parameter and moment. Adam's eps is
    1e-3, as in ``test_torch_train.py``'s step test. At least 98% of the
    parameters equal the reference's bit for bit, and every one lies
    within a bf16 step of it or 5e-2 of lr; the moments are held at the
    reference's bf16 tolerance of 2e-2 (a gradient summed in bf16 near 0
    keeps few bits in either library)."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp, tp = _bf16_params(arch, 7)
    batch = _batch(cfg, 4, 24, seed=8)
    jstep = jmake_train_step(jcfg, JTrainConfig(optimizer=JOptimizerConfig(**OCFG), **TCFG),
                             JImpl(attention="chunked", remat=False), dp=None)
    jp, jst, jm = jstep(jp, jinit_opt_state(jp, jnp.bfloat16),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(**OCFG), **TCFG))
    tp, tst, tm = step(tp, init_opt_state(tp, torch.bfloat16),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    for name, tree_t, tree_j in (("params", tp, jp), ("m", tst["m"], jst["m"]),
                                 ("v", tst["v"], jst["v"])):
        want = dict(leaves_with_paths(_np_tree(tree_j)))
        for path, t in leaves_with_paths(tree_t):
            assert t.dtype == torch.bfloat16
            w = np.asarray(want[path], np.float32)
            if name != "params":
                _close(t.float().numpy(), w, 2e-2, f"{name}/{path}")
                continue
            assert (_bits(t) == _bits(want[path])).mean() >= 0.98, path
            # a step moves a parameter by ~lr; the gradients' bf16 sums (the
            # cast's and the gather's transposes) round in another order in
            # each library, so an update may differ by a few percent of lr
            np.testing.assert_allclose(t.float().numpy(), w, rtol=2 ** -7,
                                       atol=5e-2 * OCFG["lr"],
                                       err_msg=f"{name}/{path}")


def test_one_microbatch_step_is_the_f32_sum_step():
    """The step that keeps one microbatch's bf16 gradients equals, bit for
    bit, the reference's arithmetic done in the port: the same gradients
    widened to an f32 tree, divided by 1, then AdamW."""
    cfg = get_reduced("grok-1-314b")
    _, base = _bf16_params("grok-1-314b", 9)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4, 24, seed=10).items()}
    tcfg = TrainConfig(optimizer=OptimizerConfig(**OCFG), **TCFG)
    p1 = map_tree(torch.clone, base)
    p1, s1, m1 = make_train_step(cfg, tcfg)(p1, init_opt_state(p1, torch.bfloat16), batch)
    p2 = map_tree(torch.clone, base)
    flat = [p.requires_grad_(True) for p in leaves(p2)]
    loss, _ = loss_fn(cfg, p2, batch, dtype=torch.float32)
    g32 = [g.float() / 1 for g in torch.autograd.grad(loss, flat)]
    for p in flat:
        p.requires_grad_(False)
    p2, s2, m2 = adamw_update(p2, unflatten_like(p2, g32), init_opt_state(p2, torch.bfloat16),
                              tcfg.optimizer)
    assert float(m1["loss"]) == loss.item()
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for tree1, tree2 in ((p1, p2), (s1["m"], s2["m"]), (s1["v"], s2["v"])):
        for (path, a), b in zip(leaves_with_paths(tree1), leaves(tree2)):
            assert torch.equal(a, b), path


# -- the Trainer --------------------------------------------------------------

def _grok_trainer(**kw):
    tcfg = TrainConfig(microbatch_size=4, dtype="float32", param_dtype="bfloat16",
                       optimizer=OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=10),
                       log_every=0, checkpoint_every=3, keep_checkpoints=2)
    return Trainer(get_reduced("grok-1-314b"), tcfg, global_batch=4, seq_len=32,
                   device="cpu", opt_dtype=torch.bfloat16, **kw)


def test_reduced_grok_trainer_with_bf16_state():
    """Reduced grok with bf16 parameters and moments (one microbatch a
    step) takes 10 steps; the loss falls; the state stays bf16."""
    tr = _grok_trainer()
    state = tr.init_state(tr.tcfg.seed)
    rep = tr.run(10, state=state)
    assert rep.steps_run == 10 and all(np.isfinite(rep.losses))
    assert np.mean(rep.losses[-3:]) < np.mean(rep.losses[:3]) - 0.5
    assert all(t.dtype == torch.bfloat16
               for t in leaves({"p": state["params"], "m": state["opt"]["m"],
                                "v": state["opt"]["v"]}))


def test_bf16_trainer_restarts_from_its_checkpoint():
    """A failure at step 5 restores the bf16 state written at step 3 and
    ends on the clean run's trajectory; the restored leaves are bf16."""
    with tempfile.TemporaryDirectory() as d:
        tr = _grok_trainer(checkpoint_dir=d, workers=["w0", "w1"],
                           injector=FailureInjector({5: ["w1"]}))
        rep = tr.run(8)
        assert rep.restarts == 1
        _, state = tr.restore_or_init()
    assert state["params"]["embed"]["tok"].dtype == torch.bfloat16
    assert state["opt"]["m"]["embed"]["tok"].dtype == torch.bfloat16
    clean = _grok_trainer().run(8)
    assert rep.losses[-1] == clean.losses[-1]


# -- checkpoints --------------------------------------------------------------

def _state_trees(dtype):
    """A small training state: parameters and moments in ``dtype``, an
    int32 step; as a JAX tree and a torch tree with the same bits."""
    rng = np.random.default_rng(0)
    host = {"params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                       "norm": {"scale": np.ones(5, np.float32)}},
            "opt": {"m": {"w": rng.standard_normal((3, 5)).astype(np.float32)},
                    "step": np.array(7, np.int32)}}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jstate = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt)
                          if x.dtype == np.float32 else jnp.asarray(x), host)
    tstate = map_tree(lambda x: torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))
                      if x.dtype != np.int32 else torch.from_numpy(np.array(x)),
                      _np_tree(jstate))
    return jstate, tstate


@pytest.fixture
def zlib_reference(monkeypatch):
    """The reference writes zstd manifests when ``zstandard`` is installed;
    the port reads zlib only, so the reference is made to write zlib."""
    monkeypatch.setattr(jckpt, "_CODEC", "zlib")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(zlib_reference, dtype):
    jstate, tstate = _state_trees(dtype)
    with tempfile.TemporaryDirectory() as d:
        jckpt.Checkpointer(d).save(3, jstate, blocking=True)
        step, got = Checkpointer(d).restore(tstate)
    assert step == 3
    want = dict(leaves_with_paths(_np_tree(jstate)))
    for path, leaf in leaves_with_paths(got):
        if dtype == "bfloat16" and path != "opt/step":
            assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(leaf), _bits(want[path]), err_msg=path)
        else:
            assert leaf.dtype == want[path].dtype
            np.testing.assert_array_equal(leaf, want[path], err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(dtype):
    """The reference reads the port's bf16 leaves as it reads its own
    (16-bit ``|V2`` arrays), with the same bits; the two manifests agree."""
    jstate, tstate = _state_trees(dtype)
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).save(4, tstate, blocking=True)
        step, got = jckpt.Checkpointer(d).restore(jstate)
        meta_path, codec = jckpt._find_meta(os.path.join(d, "step_4"))
        with open(meta_path, "rb") as f:
            meta = jckpt.msgpack.unpackb(jckpt._decompress_meta(f.read(), codec), raw=False)
    assert step == 4
    assert meta["dtypes"]["params/w"] == dtype and meta["dtypes"]["opt/step"] == "int32"
    for (path, t), g in zip(leaves_with_paths(tstate), jax.tree.leaves(got)):
        g = np.asarray(g)
        if dtype == "bfloat16" and path != "opt/step":
            assert g.dtype.itemsize == 2
            np.testing.assert_array_equal(_bits(g), _bits(t), err_msg=path)
        else:
            np.testing.assert_array_equal(g, t.numpy(), err_msg=path)


def test_uint16_entry_named_bfloat16_restores_as_bf16():
    """An npz entry of uint16 patterns whose manifest dtype says bfloat16
    comes back as bfloat16 too; a uint16 leaf stays uint16."""
    w = torch.tensor([1.0, -2.5, 3e-3], dtype=torch.bfloat16)
    got = tckpt._leaf(_bits(w).copy(), "bfloat16")
    assert got.dtype == torch.bfloat16 and torch.equal(got, w)
    raw = np.array([1, 2], np.uint16)
    assert tckpt._leaf(raw, "uint16") is raw


# -- launch.train ---------------------------------------------------------------

def test_train_dtype_tables_are_the_references():
    from repro.launch import dryrun
    to_name = {jnp.bfloat16: "bfloat16"}
    for ours, theirs in ((train_launcher.TRAIN_PARAM_DTYPE, dryrun.TRAIN_PARAM_DTYPE),
                         (train_launcher.TRAIN_OPT_DTYPE, dryrun.TRAIN_OPT_DTYPE)):
        assert {k: str(v).removeprefix("torch.") for k, v in ours.items()} == \
            {k: to_name[v] for k, v in theirs.items()}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,const,dtype,gb,shape", [
    ("qwen3-14b", "QWEN3_TRAIN_LAYERS", torch.float32, 46.0, (8, 2048, 2, False)),
    ("mixtral-8x7b", "MIXTRAL_TRAIN_LAYERS", torch.float32, 50.6, (2, 6144, 1, True)),
    ("llava-next-mistral-7b", "LLAVA_TRAIN_LAYERS", torch.float32, 46.1,
     (2, 6144, 1, True)),
    ("grok-1-314b", "GROK_TRAIN_LAYERS", torch.bfloat16, 52.2, (2, 2048, 2, True))])
def test_chip_smoke_training_depths_fit(arch, const, dtype, gb, shape):
    """``chip_smoke.py``'s cut depths hold the bytes of state its comments
    state (one microbatch's bf16 gradients for grok), each at most the dry
    run's ``fits_depth`` for its train line's batch, sequence, microbatch
    and remat on 80 GB (state plus activations), and the full depth is
    refused."""
    from repro_torch.launch.dryrun import fits_depth
    from repro_torch.models import Impl
    cfg = get_config(arch)
    n = getattr(_chip_smoke(), const)
    per = train_launcher.train_bytes_per_param(dtype, dtype, 1)
    assert per == (8 if dtype == torch.bfloat16 else 16)
    assert round(per * replace(cfg, num_layers=n).param_count() / 1e9, 1) == gb
    B, S, micro, remat = shape
    plan = fits_depth(cfg, "train", B, S, 80_000_000_000, micro=micro, param_dtype=dtype,
                      opt_dtype=dtype, impl=Impl(remat=remat))
    assert n <= plan["fits_depth"] < cfg.num_layers
    assert plan["need_bytes"] > 80_000_000_000


@pytest.mark.parametrize("argv,says", [
    (["--batch", "2", "--micro", "2"],
     ["bfloat16 parameters, bfloat16 gradients, bfloat16 AdamW moments, 8 bytes a "
      "parameter", "needs 2531.9 GB", "1 of its 64 layers would fit"]),
    ([], ["bfloat16 parameters, float32 gradients, bfloat16 AdamW moments, 10 bytes a "
          "parameter", "needs 3164.9 GB", "1 of its 64 layers would fit"])])
def test_launcher_refuses_full_grok_with_bf16_bytes(monkeypatch, capsys, argv, says):
    """On an 80 GB card ``--full`` grok is refused with its bf16 state's
    bytes (one microbatch a step: bf16 gradients; more: an f32 sum) and
    the depth that would fit."""
    monkeypatch.setattr(train_launcher, "card_memory", lambda device: 80_000_000_000)
    with pytest.raises(SystemExit):
        train_launcher.main(["--full", "--arch", "grok-1-314b", "--device", "cpu"] + argv)
    err = capsys.readouterr().err
    assert all(s in err for s in says), err


def test_launcher_trains_reduced_grok_in_bf16(monkeypatch, capsys):
    """``--device cpu`` trains reduced grok with ``TRAIN_PARAM_DTYPE`` and
    ``TRAIN_OPT_DTYPE`` applied."""
    seen = {}

    class Recording(Trainer):
        def init_state(self, seed=0):
            state = super().init_state(seed)
            seen["dtypes"] = {t.dtype for t in leaves({"p": state["params"],
                                                       "m": state["opt"]["m"]})}
            return state
    monkeypatch.setattr(train_launcher, "Trainer", Recording)
    train_launcher.main(["--device", "cpu", "--arch", "grok-1-314b", "--steps", "4",
                         "--seq", "16", "--batch", "4", "--micro", "2"])
    out = capsys.readouterr().out
    assert "bfloat16 parameters, bfloat16 moments" in out and "steps 4" in out
    assert seen["dtypes"] == {torch.bfloat16}
