"""Remat (``Impl(remat=True)``, the reference's ``Impl.remat``) in the
port against the port without it and against the JAX reference on the
CPU, in f32, at the reference tests' reduced configs: llama3.2-1b (dense),
mixtral-8x7b (MoE: the aux losses leave each checkpointed layer), zamba2-2.7b
(hybrid: one segment of mamba blocks and the shared block at a time),
whisper-tiny (the encoder's stack and the decoder's) and
llava-next-mistral-7b (VLM: the patch prefix). The loss and every gradient
leaf equal those without remat bit for bit; both are held to ``jax.grad`` of
the reference's ``loss_fn`` under its own ``Impl(remat=True)``; the plain
forward of each attention and mamba block runs twice under grad (the
recompute), its backward once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models.transformer import Impl as JImpl

from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import Impl, forward, loss_fn
from repro_torch.tree import leaves, leaves_with_paths

ARCHS = ["llama3.2-1b", "mixtral-8x7b", "zamba2-2.7b", "whisper-tiny",
         "llava-next-mistral-7b"]
# the reference's own model tests run remat with its chunked attention and SSD
JIMPL = JImpl(attention="chunked", ssd="chunked", q_chunk=16, kv_chunk=16, remat=True)
B, S = 2, 40


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


def _batch(cfg, seed):
    """Tokens and labels (the first 3 masked), and the inputs the family
    adds: a VLM's patch embeddings (their labels masked), an
    encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[:, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.vision_tokens:
        batch["vision_embeds"] = 0.1 * rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
        labels[:, :cfg.vision_tokens] = -1
    if cfg.enc_dec:
        batch["frames"] = 0.1 * rng.standard_normal(
            (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = jget_reduced(arch)
    jparams = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    return arch, jcfg, jparams, params_from_numpy(_np_tree(jparams), device="cpu")


def _grads(cfg, params, batch, remat):
    flat = [p.requires_grad_(True) for p in leaves(params)]
    loss, metrics = loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                            impl=Impl(remat=remat), dtype=torch.float32)
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    return loss, metrics, grads


class _Counts:
    """Calls of the plain flash attention and SSD scan, forward and
    backward: what the kernels' wrappers run for CPU tensors."""

    def __init__(self, monkeypatch):
        self.n = {}
        for mod, name in ((fa, "flash_attention_plain"), (fa, "flash_attention_bwd_plain"),
                          (ss, "ssd_scan_plain"), (ss, "ssd_scan_bwd_plain")):
            monkeypatch.setattr(mod, name, self._counted(name, getattr(mod, name)))

    def _counted(self, name, fn):
        def run(*args, **kwargs):
            self.n[name] = self.n.get(name, 0) + 1
            return fn(*args, **kwargs)
        return run

    def take(self):
        n, self.n = self.n, {}
        return n


def test_remat_equals_no_remat_bit_for_bit(model, monkeypatch):
    """Loss, aux metrics and every gradient leaf identical; the plain
    forwards run twice with remat, the backwards once; a forward under
    no_grad runs each block once either way."""
    arch, _, _, tparams = model
    cfg = get_reduced(arch)
    batch = _batch(cfg, seed=1)
    counts = _Counts(monkeypatch)
    l0, m0, g0 = _grads(cfg, tparams, batch, remat=False)
    n0 = counts.take()
    l1, m1, g1 = _grads(cfg, tparams, batch, remat=True)
    n1 = counts.take()
    assert l1.item() == l0.item()
    assert sorted(m1) == sorted(m0) and all(torch.equal(m1[k], m0[k]) for k in m0)
    for (path, _), a, b in zip(leaves_with_paths(tparams), g1, g0):
        assert torch.equal(a, b), path
    fwd = [k for k in n0 if not k.endswith("_bwd_plain")]
    assert fwd and all(n1[k] == 2 * n0[k] for k in fwd), (n0, n1)
    assert all(n1[k] == n0[k] for k in n0 if k.endswith("_bwd_plain")), (n0, n1)
    with torch.no_grad():
        forward(cfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()
                               if k != "labels"},
                impl=Impl(remat=True), dtype=torch.float32)
    assert counts.take() == {k: n0[k] for k in fwd}


def test_remat_matches_jax_grad(model):
    """Both held to ``jax.grad`` of the reference's loss under its remat:
    the loss within 2e-5, every gradient leaf within 2e-5 of its largest
    |g|."""
    arch, jcfg, jparams, tparams = model
    cfg = get_reduced(arch)
    batch = _batch(cfg, seed=2)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                           impl=JIMPL, dtype=jnp.float32), has_aux=True))(jparams)
    want = dict(leaves_with_paths(_np_tree(jg)))
    for remat in (True, False):
        loss, _, grads = _grads(cfg, tparams, batch, remat)
        assert abs(loss.item() - float(jl)) <= 2e-5 * abs(float(jl)), remat
        for (path, _), g in zip(leaves_with_paths(tparams), grads):
            w = want[path]
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max(),
                                       err_msg=f"{path} remat={remat}")
