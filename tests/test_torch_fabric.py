"""The port's device fabric against the JAX package's, on the CPU.

One world of four gloo ranks (``repro_torch.launch.world``, FileStore, no
TCP port) runs every case of ``torch_fabric_ranks.fabric_cases``; one JAX
subprocess with four host devices runs the reference's functions under
``shard_map`` on the same inputs (the reference's own tests use eight),
and the two run side by side. Held: the guarded collectives and their ok
flags exactly (``reduce_scatter_ring`` exactly on integer-valued inputs,
to 1e-6 otherwise), ``compressed_reduce`` and its residual to 1e-6 over
two steps, the tree version, the MAC words bit for bit (in this process),
capability refusals before any hop in every rank, a flipped bit refused,
the meshes and ``plan_remesh`` / ``remesh``."""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fabric_ranks as R
import torch_proc_handlers as H
from repro.core import fabric as jfabric
from repro.optim import compression as jcomp
from repro.runtime.elastic import plan_remesh as jplan_remesh
from repro_torch.core import fabric
from repro_torch.launch.world import run_world
from repro_torch.optim import compression
from repro_torch.runtime.elastic import plan_remesh

pytestmark = pytest.mark.proc

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4

JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.utils import shard_map
from repro.core.fabric import (MPKLinkFabric, neighbor_exchange, ring_all_gather,
                               reduce_scatter_ring, all_to_all, psum_guarded)
from repro.optim import compressed_reduce, compressed_tree_reduce

inp = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
mesh = jax.make_mesh((4,), ("x",))
fab = MPKLinkFabric(mesh, guard=True)
chan, key = fab.establish("tp", "x")
out = {"seed": np.uint32(chan.seed)}
X = P("x")

def run(f, *args, n_out=2):
    specs = (X,) * len(args)
    return jax.jit(shard_map(f, mesh=mesh, in_specs=specs,
                             out_specs=(X,) * n_out if n_out > 1 else X))(*args)

def with_ok(r):
    return r[0], r[1][None]

for shift in (1, 2, 3):
    y, ok = run(lambda xl: with_ok(neighbor_exchange(fab, chan, key, xl, shift=shift)),
                inp["x"])
    out[f"ne{shift}"], out[f"ne{shift}_ok"] = y, ok
out["ag"], out["ag_ok"] = run(lambda xl: with_ok(ring_all_gather(fab, chan, key, xl)),
                              inp["x"])
for name in ("rs_int", "rs_float"):
    s, ok = run(lambda xl: (lambda r: (r[0][None], r[1][None]))(
        reduce_scatter_ring(fab, chan, key, xl[0])), inp[name])
    out[name], out[name + "_ok"] = s, ok
out["a2a"] = run(lambda xl: all_to_all(fab, chan, key, xl, split_axis=1,
                                       concat_axis=0), inp["a2a"], n_out=1)
out["a2a3"] = run(lambda xl: all_to_all(fab, chan, key, xl[0], split_axis=0,
                                        concat_axis=1)[None], inp["a2a3"], n_out=1)
out["psum"] = run(lambda xl: psum_guarded(fab, chan, key, xl), inp["psum"], n_out=1)

def cr(gl, ef):
    o, e = compressed_reduce(gl[0], ef[0], "x")
    return o[None], e[None]
ef = inp["ef0"]
for step in (1, 2):
    o, ef = run(cr, inp[f"cr_g{step}"], ef)
    out[f"cr_out{step}"], out[f"cr_ef{step}"] = o, ef
out["cr_odd_out"], out["cr_odd_ef"] = run(cr, inp["cr_odd"], jnp.zeros_like(inp["cr_odd"]))

def tr(ga, gc, efa, efc):
    red, new = compressed_tree_reduce({"a": ga[0], "b": {"c": gc[0]}},
                                      {"a": efa[0], "b": {"c": efc[0]}}, "x")
    return red["a"][None], red["b"]["c"][None], new["a"][None]
out["tree_a"], out["tree_c"], out["tree_ef_a"] = run(
    tr, inp["cr_g1"], inp["cr_odd"], inp["ef0"], jnp.zeros_like(inp["cr_odd"]), n_out=3)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""


def _inputs(rng) -> dict:
    n = WORLD
    return {
        "x": rng.standard_normal((4 * n, 5)).astype(np.float32),
        "rs_int": rng.integers(-50, 50, (n, 8, 3)).astype(np.float32),
        "rs_float": rng.standard_normal((n, 8, 3)).astype(np.float32),
        "a2a": np.arange(n * 2 * n, dtype=np.float32).reshape(n, 2 * n),
        "a2a3": rng.standard_normal((n, 2 * n, 3, 2)).astype(np.float32),
        "psum": rng.integers(-9, 9, (n, 6)).astype(np.float32),
        "cr_g1": rng.standard_normal((n, 16, 4)).astype(np.float32),
        "cr_g2": rng.standard_normal((n, 16, 4)).astype(np.float32),
        "ef0": np.zeros((n, 4, 4), np.float32),
        "cr_odd": rng.standard_normal((n, 6, 3)).astype(np.float32),
    }


def _shm_names() -> set:
    return set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(inputs, JAX outputs, the four ranks' outputs), from one JAX
    subprocess and one world run side by side; afterwards no rank process,
    store file or shared-memory segment of theirs is left."""
    tmp = tmp_path_factory.mktemp("fabric")
    inp = _inputs(np.random.default_rng(20))
    path = str(tmp / "inputs.npz")
    np.savez(path, **inp)
    shm_before = _shm_names()
    env = dict(os.environ, PYTHONPATH="src")
    ref = subprocess.Popen([sys.executable, "-c", JAX_CODE, path, str(tmp / "ref.npz")],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        with H.bounded(240):
            t0 = time.monotonic()
            ranks = run_world(R.fabric_cases, WORLD, path, device="cpu",
                              timeout=180, init_timeout=60, store_dir=str(tmp))
            world_s = time.monotonic() - t0
            stdout, stderr = ref.communicate(timeout=200)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert "OK" in stdout, stdout + stderr
    H.proc_hygiene(__name__)
    assert not (tmp / "store").exists()
    assert not [n for n in _shm_names() - shm_before if n.startswith("torch_")]
    jref = dict(np.load(tmp / "ref.npz"))
    return inp, jref, ranks, world_s


def _cat(ranks, name):
    return np.concatenate([r[name] for r in ranks], axis=0)


def test_world_leaves_nothing_and_ranks_agree_on_the_channel(results):
    inp, jref, ranks, world_s = results
    assert [int(r["world_rank"][0]) for r in ranks] == list(range(WORLD))
    # every rank derives the same channel seed (the reference's, one
    # process for every device, comes from that process's string hash)
    chan, _ = fabric.MPKLinkFabric().establish("tp", "x")
    assert {int(r["seed"]) for r in ranks} == {chan.seed}
    assert chan.tag == fabric.channel_tag("tp", "x", chan.domain.did)
    assert world_s < 120


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_neighbor_exchange_equals_the_reference(results, shift):
    _, jref, ranks, _ = results
    np.testing.assert_array_equal(_cat(ranks, f"ne{shift}"), jref[f"ne{shift}"])
    np.testing.assert_array_equal(_cat(ranks, f"ne{shift}_ok"), jref[f"ne{shift}_ok"])
    assert (jref[f"ne{shift}_ok"] == 1).all()


def test_ring_all_gather_equals_the_reference(results):
    inp, jref, ranks, _ = results
    np.testing.assert_array_equal(_cat(ranks, "ag"), jref["ag"])
    for r in ranks:
        np.testing.assert_array_equal(r["ag"], inp["x"])
        assert int(r["ag_ok"][0]) == 1


def test_reduce_scatter_ring_integer_valued_is_exact(results):
    inp, jref, ranks, _ = results
    got = _cat(ranks, "rs_int")
    np.testing.assert_array_equal(got, jref["rs_int"])
    np.testing.assert_array_equal(got.reshape(8, 3), inp["rs_int"].sum(0))
    assert (_cat(ranks, "rs_int_ok") == 1).all()


def test_reduce_scatter_ring_float(results):
    _, jref, ranks, _ = results
    np.testing.assert_allclose(_cat(ranks, "rs_float"), jref["rs_float"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_cat(ranks, "rs_float_ok"), jref["rs_float_ok"])


@pytest.mark.parametrize("name", ["a2a", "a2a3"])
def test_all_to_all_equals_the_reference(results, name):
    _, jref, ranks, _ = results
    np.testing.assert_array_equal(_cat(ranks, name), jref[name])


def test_all_to_all_is_the_transpose(results):
    inp, _, ranks, _ = results
    np.testing.assert_array_equal(_cat(ranks, "a2a").reshape(WORLD, 2 * WORLD)
                                  .reshape(WORLD, WORLD, 2).transpose(1, 0, 2)
                                  .reshape(WORLD, 2 * WORLD), inp["a2a"])


def test_psum_guarded_equals_the_reference(results):
    inp, jref, ranks, _ = results
    np.testing.assert_array_equal(_cat(ranks, "psum"), jref["psum"])
    for r in ranks:
        np.testing.assert_array_equal(r["psum"][0], inp["psum"].sum(0))


def test_foreign_and_revoked_keys_refused_before_any_hop_in_every_rank(results):
    _, _, ranks, _ = results
    for r in ranks:
        assert r["foreign_refused"].tolist() == [True] * 4
        assert r["revoked_refused"].tolist() == [True]
        assert float(r["after_refusals"][0]) == WORLD     # no rank was left behind


def test_a_flipped_bit_fails_the_mac(results):
    _, _, ranks, _ = results
    for r in ranks:
        assert int(r["mac_clean_ok"][0]) == 1
        assert int(r["mac_flipped_ok"][0]) == 0


@pytest.mark.parametrize("step", [1, 2])
def test_compressed_reduce_and_residual_equal_the_reference(results, step):
    inp, jref, ranks, _ = results
    out, ef = _cat(ranks, f"cr_out{step}"), _cat(ranks, f"cr_ef{step}")
    np.testing.assert_allclose(out, jref[f"cr_out{step}"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ef, jref[f"cr_ef{step}"], rtol=1e-6, atol=1e-6)
    # the reference test's own checks, through np.asarray(out)[d]
    exact = inp[f"cr_g{step}"].mean(0)
    for d in range(WORLD):
        assert np.abs(np.asarray(out)[d] - exact).max() < np.abs(exact).max() / 50
    assert np.abs(ef).max() > 0


def test_compressed_reduce_falls_back_to_exact_mean(results):
    inp, jref, ranks, _ = results
    out = _cat(ranks, "cr_odd_out")
    np.testing.assert_allclose(out, jref["cr_odd_out"], rtol=1e-6, atol=1e-6)
    for d in range(WORLD):
        np.testing.assert_allclose(out[d], inp["cr_odd"].mean(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_cat(ranks, "cr_odd_ef"), 0)


def test_compressed_tree_reduce_equals_the_reference(results):
    _, jref, ranks, _ = results
    for name in ("tree_a", "tree_c", "tree_ef_a"):
        np.testing.assert_allclose(_cat(ranks, name), jref[name], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_cat(ranks, "tree_a"), _cat(ranks, "cr_out1"))


def test_meshes_and_remesh_in_a_world_of_four(results):
    _, _, ranks, _ = results
    for rank, r in enumerate(ranks):
        assert r["mesh2_coord"].tolist() == [rank // 2, rank % 2]
        # a channel over "model" shifts within each row of two
        assert float(r["mesh2_shift"][0]) == float(rank ^ 1)
        assert int(r["mesh2_ok"][0]) == 1
        assert r["production_refused"].tolist() == [True]
        assert r["dp_axes"].tolist() == [True, True]
        assert r["remesh_full"].tolist() == [2, 2, rank // 2, rank % 2]
        assert r["remesh_part"].tolist() == [1, 2, rank if rank < 2 else -1]
        assert r["remesh_refused"].tolist() == [True]


# ---------------------------------------------------------------------------
# in this process: MAC words, quantization, residual shapes, the planner
# ---------------------------------------------------------------------------

def _mac_cases():
    rng = np.random.default_rng(3)
    return {
        "f32": rng.standard_normal(300).astype(np.float32),
        "bf16_odd": rng.standard_normal(257).astype(np.float32),   # cast below
        "int32": rng.integers(-2 ** 31, 2 ** 31, (5, 128), dtype=np.int64).astype(np.int32),
        "f64": rng.standard_normal((3, 7)),
        "int64": rng.integers(-2 ** 62, 2 ** 62, 77, dtype=np.int64),
        "f32_ragged": rng.standard_normal((3, 129)).astype(np.float32),
    }


@pytest.mark.parametrize("case", list(_mac_cases()))
def test_attach_mac_words_bit_for_bit(case):
    a = _mac_cases()[case]
    seed = 0x9E3779B9
    if case == "bf16_odd":
        jx = jnp.asarray(a, jnp.bfloat16)
        tx = torch.from_numpy(a).to(torch.bfloat16)
        want = int(jfabric.attach_mac(jx, seed))
    elif a.itemsize == 8:
        with jax.enable_x64(True):
            jx = jnp.asarray(a)
            assert jx.dtype.itemsize == 8
            want = int(jfabric.attach_mac(jx, seed))
        tx = torch.from_numpy(a)
    else:
        want = int(jfabric.attach_mac(jnp.asarray(a), seed))
        tx = torch.from_numpy(a)
    got = fabric.attach_mac(tx, seed)
    assert got.dtype == torch.uint32 and got.ndim == 0
    assert int(got.view(torch.int32).item()) & 0xFFFFFFFF == want
    assert int(fabric.verify_mac(tx, got, seed)) == 1
    assert int(fabric.verify_mac(tx, got, seed ^ 1)) == 0


def test_as_u32_rows_layout_matches_the_reference():
    a = np.arange(1, 300, dtype=np.float32)
    want = np.asarray(jfabric._as_u32_rows(jnp.asarray(a)))
    got = fabric._as_u32_rows(torch.from_numpy(a)).view(torch.int32).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)
    with pytest.raises(ValueError):
        fabric._as_u32_rows(torch.zeros(4, dtype=torch.int8))


def test_quantize_int8_rounds_half_to_even_as_the_reference():
    x = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.49, -127.0], np.float32)
    for a in (x, np.random.default_rng(5).standard_normal(999).astype(np.float32)):
        jq, js = jcomp.quantize_int8(jnp.asarray(a))
        tq, ts = compression.quantize_int8(torch.from_numpy(a))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)
        np.testing.assert_array_equal(compression.dequantize_int8(tq, ts).numpy(),
                                      np.asarray(jcomp.dequantize_int8(jq, js)))
    assert tq.dtype == torch.int8


def test_init_error_feedback_shapes_as_the_reference():
    shapes = {"a": (8, 3), "b": {"c": (6, 2), "d": ()}}

    def tree(mk, s):
        return {k: tree(mk, v) if isinstance(v, dict) else mk(v) for k, v in s.items()}
    j = jcomp.init_error_feedback(tree(jnp.zeros, shapes), 4)
    t = compression.init_error_feedback(tree(torch.zeros, shapes), 4)
    assert tuple(t["a"].shape) == j["a"].shape == (2, 3)
    assert tuple(t["b"]["c"].shape) == j["b"]["c"].shape == (6, 2)
    assert tuple(t["b"]["d"].shape) == j["b"]["d"].shape == (1,)
    assert t["a"].dtype == torch.float32


def test_plan_remesh_equals_the_reference():
    for alive in range(0, 600, 7):
        for tp in (1, 2, 4, 8, 16, 32):
            assert plan_remesh(alive, tp) == jplan_remesh(alive, tp), (alive, tp)
            axes = ("d", "m")
            assert plan_remesh(alive, tp, axes) == jplan_remesh(alive, tp, axes)
