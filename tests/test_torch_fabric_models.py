"""The fabric's four users in the port against the JAX package's, on the
CPU: ring attention, expert-parallel MoE, the GPipe pipeline (forward and
gradients).

One world of four gloo ranks runs ``torch_fabric_ranks.model_cases``
beside one JAX subprocess with four host devices that runs the
reference's functions under ``shard_map`` on the same inputs, at the
reference tests' own small shapes (ring attention B 2, S 64, H 4, Hkv 2,
Dh 16; reduced mixtral with one expert a rank; reduced llama with 8
layers as 4 stages of 2, 4 microbatches). Tolerances: ring attention
3e-5 (``tests/test_ring_attention.py``), MoE 2e-4 (``tests/test_moe_ep.py``,
also against the dense ``apply_moe`` with routing groups of one row),
the pipeline 2e-5 forward and 5e-4 gradients (``tests/test_pipeline.py``).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_fabric_ranks as R
import torch_proc_handlers as H
from repro.configs import get_reduced as jget_reduced
from repro.configs import replace as jreplace
from repro.kernels.ref import attention_ref
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.launch.world import run_world
from repro_torch.tree import leaves_with_paths

pytestmark = pytest.mark.proc

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4

JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.utils import shard_map
from repro.configs import get_reduced, replace
from repro.core.fabric import MPKLinkFabric
from repro.core.ring_attention import ring_attention
from repro.models.moe_ep import apply_moe_ep
from repro.models.transformer import Impl
from repro.runtime.pipeline import pipeline_apply, stage_split

RING_CASES = ((True, None), (True, 24), (False, None))
MOE_CAPACITIES = (16.0, 1.25)
inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((4,), ("x",))
out = {}

def tree(prefix):
    t = {}
    for path, a in inp.items():
        if path.startswith(prefix + "/"):
            *heads, last = path[len(prefix) + 1:].split("/")
            node = t
            for h in heads:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(a)
    return t

def flat(t, prefix):
    if isinstance(t, dict):
        return [kv for k in sorted(t) for kv in flat(t[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(t))]

fab = MPKLinkFabric(mesh, guard=True)
chan, key = fab.establish("ring-kv", "x")
S = P(None, "x")
for i, (causal, window) in enumerate(RING_CASES):
    def ring(ql, kl, vl, pl):
        o, ok = ring_attention(fab, chan, key, ql, kl, vl, pl, pl, causal=causal,
                               window=window, q_chunk=8, kv_chunk=8)
        return o, ok[None]
    o, ok = jax.jit(shard_map(ring, mesh=mesh, in_specs=(S, S, S, S),
                              out_specs=(S, P("x"))))(
        *(jnp.asarray(inp[n]) for n in ("q", "k", "v", "pos")))
    out[f"ring{i}"], out[f"ring{i}_ok"] = o, ok

fab_ep = MPKLinkFabric(mesh, guard=False)
chan_ep, key_ep = fab_ep.establish("moe-dispatch", "x")
base = get_reduced("mixtral-8x7b")
for i, cf in enumerate(MOE_CAPACITIES):
    cfg = replace(base, moe=replace(base.moe, capacity_factor=cf))
    def ep(xl, router, gate, up, down):
        w = {"router": router, "gate": gate, "up": up, "down": down}
        y, aux = apply_moe_ep(cfg, w, xl, fabric=fab_ep, chan=chan_ep, key=key_ep)
        return y, aux["moe_drop_frac"][None]
    y, drop = jax.jit(shard_map(ep, mesh=mesh,
                                in_specs=(P("x"), P(), P("x"), P("x"), P("x")),
                                out_specs=(P("x"), P("x"))))(
        *(jnp.asarray(inp["moe_" + n]) for n in ("x", "router", "gate", "up", "down")))
    out[f"moe{i}"], out[f"moe{i}_drop"] = y, drop

cfg = replace(get_reduced("llama3.2-1b"), num_layers=8)
impl = Impl(attention="naive", remat=False)
fab_p = MPKLinkFabric(mesh, guard=True)
chan_p, key_p = fab_p.establish("stage-handoff", "x")
staged = stage_split(tree("stack"), 4)
specs = jax.tree.map(lambda a: P("x"), staged)
xm = jnp.asarray(inp["pipe_x"])

def pipe(sp, x):
    o, ok = pipeline_apply(cfg, sp, x, fabric=fab_p, chan=chan_p, key=key_p, impl=impl)
    return o, ok[None]
o, ok = jax.jit(shard_map(pipe, mesh=mesh, in_specs=(specs, P()),
                          out_specs=(P(), P("x"))))(staged, xm)
out["pipe"], out["pipe_ok"] = o, ok

def loss(sp, x):
    o, _ = pipeline_apply(cfg, sp, x, fabric=fab_p, chan=chan_p, key=key_p, impl=impl)
    return (o ** 2).sum()
g = jax.jit(shard_map(jax.grad(loss), mesh=mesh, in_specs=(specs, P()),
                      out_specs=specs))(staged, xm)
for path, a in flat(g, "grad"):
    out[path] = a
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""


def _inputs(rng) -> dict:
    r = R.RING
    inp = {
        "q": rng.standard_normal((r["B"], r["S"], r["H"], r["Dh"])).astype(np.float32),
        "k": rng.standard_normal((r["B"], r["S"], r["Hkv"], r["Dh"])).astype(np.float32),
        "v": rng.standard_normal((r["B"], r["S"], r["Hkv"], r["Dh"])).astype(np.float32),
        "pos": np.broadcast_to(np.arange(r["S"], dtype=np.int32), (r["B"], r["S"])).copy(),
    }
    mcfg = jget_reduced("mixtral-8x7b")
    assert mcfg.moe.num_experts == R.MOE["E"]
    for name, a in jmoe.init_moe(mcfg, jax.random.PRNGKey(0)).items():
        inp["moe_" + name] = np.asarray(a)
    inp["moe_x"] = rng.standard_normal(
        (R.MOE["B"], R.MOE["S"], mcfg.d_model)).astype(np.float32)
    pcfg = jreplace(jget_reduced("llama3.2-1b"), num_layers=R.PIPE["layers"])
    stacked = jtf.init_stack(pcfg, jax.random.PRNGKey(1), pcfg.num_layers)
    for path, a in leaves_with_paths(jax.tree.map(np.asarray, stacked)):
        inp["stack/" + path] = a
    p = R.PIPE
    inp["pipe_x"] = rng.standard_normal(
        (p["n_micro"], p["mb"], p["S"], pcfg.d_model)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(inputs, JAX outputs, the four ranks' outputs) from one JAX
    subprocess and one world run side by side; afterwards no rank
    process and no store file is left."""
    tmp = tmp_path_factory.mktemp("fabric_models")
    inp = _inputs(np.random.default_rng(21))
    path = str(tmp / "inputs.npz")
    np.savez(path, **inp)
    env = dict(os.environ, PYTHONPATH="src")
    ref = subprocess.Popen([sys.executable, "-c", JAX_CODE, path, str(tmp / "ref.npz")],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        with H.bounded(300):
            ranks = run_world(R.model_cases, WORLD, path, device="cpu",
                              timeout=240, init_timeout=90, store_dir=str(tmp))
            stdout, stderr = ref.communicate(timeout=280)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert "OK" in stdout, stdout + stderr
    H.proc_hygiene(__name__)
    assert not (tmp / "store").exists()
    return inp, dict(np.load(tmp / "ref.npz")), ranks


def _seq(ranks, name):
    """The ranks' sequence blocks (dim 1) put back together."""
    return np.concatenate([r[name] for r in ranks], axis=1)


def _cat(ranks, name):
    return np.concatenate([r[name] for r in ranks], axis=0)


@pytest.mark.parametrize("case", range(len(R.RING_CASES)))
def test_ring_attention_equals_the_reference(results, case):
    inp, jref, ranks = results
    got = _seq(ranks, f"ring{case}")
    np.testing.assert_allclose(got, jref[f"ring{case}"], rtol=3e-5, atol=3e-5)
    causal, window = R.RING_CASES[case]
    oracle = attention_ref(*(jnp.asarray(inp[n]) for n in ("q", "k", "v", "pos", "pos")),
                           causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=3e-5, atol=3e-5)
    assert (_cat(ranks, f"ring{case}_ok") == 1).all()


@pytest.mark.parametrize("case", range(len(R.MOE_CAPACITIES)))
def test_moe_ep_equals_the_reference_and_dense_dispatch(results, case):
    inp, jref, ranks = results
    got = _cat(ranks, f"moe{case}")
    np.testing.assert_allclose(got, jref[f"moe{case}"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_cat(ranks, f"moe{case}_drop"), jref[f"moe{case}_drop"],
                               rtol=1e-6, atol=1e-6)
    cfg = jget_reduced("mixtral-8x7b")
    cfg = jreplace(cfg, moe=jreplace(cfg.moe, capacity_factor=R.MOE_CAPACITIES[case],
                                     group_size=R.MOE["S"]))
    w = {n: jnp.asarray(inp["moe_" + n]) for n in ("router", "gate", "up", "down")}
    dense, _ = jmoe.apply_moe(cfg, w, jnp.asarray(inp["moe_x"]))
    np.testing.assert_allclose(got, np.asarray(dense), rtol=2e-4, atol=2e-4)


def test_moe_ep_at_the_configs_capacity_drops_pairs(results):
    _, _, ranks = results
    assert _cat(ranks, "moe0_drop").max() == 0
    assert _cat(ranks, "moe1_drop").max() > 0


def test_pipeline_forward_equals_the_reference(results):
    inp, jref, ranks = results
    for r in ranks:                            # valid in every rank
        np.testing.assert_allclose(r["pipe"], jref["pipe"], rtol=2e-5, atol=2e-5)
        assert int(r["pipe_ok"][0]) == 1


def test_pipeline_gradients_equal_jax_grad(results):
    _, jref, ranks = results
    names = sorted(k for k in jref if k.startswith("grad/"))
    assert names and names == sorted(k for k in ranks[0] if k.startswith("grad/"))
    for name in names:
        got = _cat(ranks, name)
        assert got.shape == jref[name].shape, name
        assert np.abs(got).max() > 0, name
        np.testing.assert_allclose(got, jref[name], rtol=5e-4, atol=5e-4, err_msg=name)
