"""Elastic restore in the port (``runtime.elastic.elastic_restore``,
``Checkpointer.restore_placed``), the port of the reference's
``tests/test_data_checkpoint.py::test_elastic_reshard_restore`` round trip,
on the CPU. One world of four gloo ranks (``launch.world.run_world``) restores
a checkpoint written by the reference's ``Checkpointer`` (reduced
llama3.2-1b's parameters, an (8, 8) leaf and a bf16 leaf) onto a (2, 2)
("data", "model") mesh under ``fsdp_tp``; rank 0 saves the gathered arrays
with the port's ``Checkpointer``; two ranks are lost and the rest restore
that onto ``remesh(2, tp=2)``'s (1, 2) mesh. Every rank's local shard
equals the numpy slice of the reference's array, bit for bit; its shape
equals ``local_shape`` and its placements ``placements``."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_elastic_ranks as E
import torch_proc_handlers as H
from repro.checkpoint import checkpointer as jckpt
from repro.configs import get_reduced as jget_reduced
from repro.models import init_params as jinit_params
from repro.sharding.specs import param_specs as jparam_specs
from repro_torch.launch.world import run_world

pytestmark = pytest.mark.proc

WORLD = 4
STEP = 5


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in flat}


def _slice(a, spec, coord, sizes):
    """The shard of ``a`` at mesh coordinate ``coord`` ({axis: index})
    under the reference's PartitionSpec ``spec``."""
    index = []
    for d, n in enumerate(a.shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        k, i = 1, 0
        for ax in axes:
            k *= sizes[ax]
            i = i * sizes[ax] + coord[ax]
        index.append(slice(i * (n // k), (i + 1) * (n // k)))
    return a[tuple(index)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's checkpoint, the ranks' results and the wall time;
    afterwards no rank process and no store file is left."""
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = jget_reduced(E.ARCH)
    tree = {"params": jinit_params(cfg, jax.random.PRNGKey(3)),
            "w": jnp.arange(64.0).reshape(8, 8),
            "wb": (jnp.arange(32.0).reshape(8, 4) / 7).astype(jnp.bfloat16)}
    codec = jckpt._CODEC
    jckpt._CODEC = "zlib"                      # the port reads zlib manifests
    try:
        jckpt.Checkpointer(str(tmp / "ckpt")).save(STEP, tree, blocking=True)
    finally:
        jckpt._CODEC = codec
    with H.bounded(240):
        t0 = time.monotonic()
        ranks = run_world(E.elastic_cases, WORLD, str(tmp / "ckpt"), device="cpu",
                          timeout=180, init_timeout=60, store_dir=str(tmp))
        wall = time.monotonic() - t0
    H.proc_hygiene(__name__)
    assert not (tmp / "store").exists()
    specs = {"params": jparam_specs(cfg, tree["params"], policy="fsdp_tp",
                                    axis_sizes={"data": 2, "model": 2}),
             "w": jax.sharding.PartitionSpec("data", "model"),
             "wb": jax.sharding.PartitionSpec(("data", "model"), None)}
    specs_b = dict(specs, params=jparam_specs(cfg, tree["params"], policy="fsdp_tp",
                                              axis_sizes={"data": 1, "model": 2}))
    host = {p: np.asarray(a) for p, a in _jflat(tree).items()}
    return host, _jflat(specs), _jflat(specs_b), ranks, wall


def _bits(a):
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def test_reference_checkpoint_placed_on_2x2_bit_for_bit(world):
    host, specs, _, ranks, _ = world
    assert len(host) > 10
    for rank, r in enumerate(ranks):
        assert r["step_a"] == STEP
        coord = dict(zip(("data", "model"), r["coord_a"]))
        assert coord == {"data": rank // 2, "model": rank % 2}
        assert set(r["a"]) == set(host)
        for path, (local, ok) in r["a"].items():
            assert ok, (rank, path)
            want = _bits(_slice(host[path], specs[path], coord, {"data": 2, "model": 2}))
            assert local.shape == want.shape and np.array_equal(local, want), (rank, path)


def test_sharded_leaves_differ_across_ranks(world):
    """fsdp_tp splits the big leaves: the (2, 2) shards are a quarter or a
    half of the leaf, not copies."""
    host, _, _, ranks, _ = world
    local = ranks[0]["a"]["params/blocks/ffn/up"][0]
    assert local.size * 4 == host["params/blocks/ffn/up"].size
    assert not np.array_equal(ranks[0]["a"]["w"][0], ranks[3]["a"]["w"][0])


def test_port_checkpoint_placed_on_the_1x2_remesh_bit_for_bit(world):
    host, _, specs_b, ranks, _ = world
    for rank, r in enumerate(ranks):
        if rank >= 2:
            assert r["coord_b"] is None and "b" not in r
            continue
        assert r["step_b"] == E.RESAVED_STEP
        coord = dict(zip(("data", "model"), r["coord_b"]))
        assert coord == {"data": 0, "model": rank}
        for path, (local, ok) in r["b"].items():
            assert ok, (rank, path)
            want = _bits(_slice(host[path], specs_b[path], coord, {"data": 1, "model": 2}))
            assert np.array_equal(local, want), (rank, path)


def test_world_bounded(world):
    *_, wall = world
    assert wall < 120
