"""The port's data and checkpoints against the reference: synthetic batches
equal bit for bit for the same seed and step; a checkpoint written by
``repro.checkpoint.Checkpointer`` restores in the port and one written by
the port restores in the reference; the reference's retention, atomicity,
tree-mismatch and async tests (``tests/test_data_checkpoint.py``) ported;
and the port's own MessagePack subset held to the ``msgpack`` package in
both directions."""
import os
import tempfile
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint.checkpointer as jckpt
from repro.configs import get_reduced as jget_reduced
from repro.data import SyntheticDataset as JSyntheticDataset

from repro_torch.checkpoint import Checkpointer, msgpack_lite
from repro_torch.configs import get_reduced
from repro_torch.data import Prefetcher, SyntheticDataset
from repro_torch.tree import leaves_with_paths


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
@pytest.mark.parametrize("seed,step,batch,seq", [(0, 0, 4, 32), (7, 5, 3, 17),
                                                 (123, 1000, 2, 300)])
def test_batches_equal_the_reference(arch, seed, step, batch, seq):
    want = JSyntheticDataset(jget_reduced(arch), seq, seed=seed).batch(step, batch)
    got = SyntheticDataset(get_reduced(arch), seq, seed=seed).batch(step, batch)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_batch_equals_samples():
    ds = SyntheticDataset(get_reduced("llama3.2-1b"), seq_len=16, seed=1)
    b = ds.batch(5, 3)
    for r in range(3):
        for k, v in ds.sample(5, r).items():
            np.testing.assert_array_equal(b[k][r], v, err_msg=k)


def test_restart_equivalence():
    cfg = get_reduced("llama3.2-1b")
    a, b = SyntheticDataset(cfg, 32, seed=7), SyntheticDataset(cfg, 32, seed=7)
    _ = a.batch(0, 4), a.batch(1, 4)
    np.testing.assert_array_equal(a.batch(2, 4)["tokens"], b.batch(2, 4)["tokens"])


def test_seed_changes_stream():
    cfg = get_reduced("llama3.2-1b")
    a = SyntheticDataset(cfg, 32, seed=1).batch(0, 2)["tokens"]
    b = SyntheticDataset(cfg, 32, seed=2).batch(0, 2)["tokens"]
    assert not np.array_equal(a, b)


def test_prefetcher_orders_steps_and_places_tensors():
    ds = SyntheticDataset(get_reduced("llama3.2-1b"), 8, seed=0)
    pf = Prefetcher(ds, global_batch=2, start_step=3, prefetch=2, device="cpu")
    try:
        got = [next(pf) for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    step, batch = got[1]
    assert isinstance(batch["tokens"], torch.Tensor)
    np.testing.assert_array_equal(batch["tokens"].numpy(), ds.batch(4, 2)["tokens"])


# -- checkpointing -------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "nest": {"b": torch.ones(4, dtype=torch.int32),
                     "s": torch.tensor(7, dtype=torch.int32)}}


def _jtree():
    return {"a": jnp.arange(6.0).reshape(2, 3),
            "nest": {"b": jnp.ones(4, jnp.int32), "s": jnp.int32(7)}}


def _state_trees():
    """A training state's layout: params and opt with m, v and the step."""
    rng = np.random.default_rng(0)
    params = {"blocks": {"attn": {"wq": rng.standard_normal((2, 8, 2, 4))},
                         "ln1": {"scale": np.ones((2, 8))}},
              "embed": {"tok": rng.standard_normal((16, 8))},
              "final_norm": {"scale": np.ones(8)}}
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    state = {"params": params,
             "opt": {"m": jax.tree.map(lambda x: x * 0.5, params),
                     "v": jax.tree.map(lambda x: x * x, params),
                     "step": np.array(3, np.int32)}}
    return state, jax.tree.map(jnp.asarray, state), jax.tree.map(torch.from_numpy, state)


@pytest.fixture
def zlib_reference(monkeypatch):
    """The reference writes zstd manifests when ``zstandard`` is installed;
    the port reads zlib only, so the reference is made to write zlib."""
    monkeypatch.setattr(jckpt, "_CODEC", "zlib")


def test_reference_checkpoint_restores_in_the_port(zlib_reference):
    host, jstate, tstate = _state_trees()
    with tempfile.TemporaryDirectory() as d:
        jckpt.Checkpointer(d).save(11, jstate, blocking=True)
        step, got = Checkpointer(d).restore(tstate)
    assert step == 11
    want = dict(leaves_with_paths(host))
    for path, leaf in leaves_with_paths(got):
        assert leaf.dtype == want[path].dtype
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
    assert sorted(want) == sorted(p for p, _ in leaves_with_paths(got))


def test_port_checkpoint_restores_in_the_reference():
    host, jstate, tstate = _state_trees()
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).save(12, tstate, blocking=True)
        assert sorted(os.listdir(os.path.join(d, "step_12"))) == [
            "arrays.npz", "meta.msgpack.zlib"]
        step, got = jckpt.Checkpointer(d).restore(jstate)
    assert step == 12
    for (pw, w), (pg, g) in zip(leaves_with_paths(host), leaves_with_paths(got)):
        assert pw == pg
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=pw)


def test_manifest_matches_the_reference_one(zlib_reference):
    """The two manifests of the same tree hold the same keys, shapes and
    dtypes; the port's describes the tree as the reference's treedef."""
    _, jstate, tstate = _state_trees()
    metas = []
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        jckpt.Checkpointer(d1).save(1, jstate, blocking=True)
        Checkpointer(d2).save(1, tstate, blocking=True)
        for d in (d1, d2):
            with open(os.path.join(d, "step_1", "meta.msgpack.zlib"), "rb") as f:
                metas.append(msgpack.unpackb(zlib.decompress(f.read()), raw=False))
    want, got = metas
    for key in ("step", "codec", "keys", "shapes", "dtypes"):
        assert got[key] == want[key], key
    assert got["treedef"] == want["treedef"]


def test_roundtrip_and_retention():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        for step in (1, 2, 3):
            ck.save(step, _tree(), blocking=True)
        assert ck.list_steps() == [2, 3]
        s, restored = ck.restore(_tree())
        assert s == 3
        for (_, a), (_, b) in zip(leaves_with_paths(_tree()), leaves_with_paths(restored)):
            np.testing.assert_array_equal(a.numpy(), b)


def test_no_partial_checkpoint_visible():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=3)
        ck.save(1, _tree(), blocking=True)
        os.makedirs(os.path.join(d, ".tmp_2"))
        with open(os.path.join(d, ".tmp_2", "arrays.npz"), "w") as f:
            f.write("garbage")
        assert ck.latest_step() == 1
        s, _ = ck.restore(_tree())
        assert s == 1


def test_tree_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, _tree(), blocking=True)
        with pytest.raises(ValueError, match="mismatch"):
            ck.restore({"different": torch.zeros(1)})


def test_async_save_then_wait():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=5)
        futs = [ck.save(s, _tree()) for s in range(3)]
        ck.wait()
        assert all(f.done() for f in futs)
        assert ck.list_steps() == [0, 1, 2]


def test_save_snapshots_before_in_place_updates():
    """The train step updates parameters in place: what an async save
    writes is the tree as it was when save() returned."""
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        t = _tree()
        ck.save(1, t)
        t["a"].add_(100.0)
        ck.wait()
        _, got = ck.restore(_tree())
        np.testing.assert_array_equal(got["a"], np.arange(6.0).reshape(2, 3))


def test_bf16_leaf_raises():
    """A bfloat16 leaf no longer raises: it is written as its 16-bit
    patterns (npz ``|V2``, "bfloat16" in the manifest, as the reference
    writes it) and restored as a bfloat16 tensor with the same bits."""
    w = torch.randn(3, 5).to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).save(1, {"w": w}, blocking=True)
        _, got = Checkpointer(d).restore({"w": w})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))


def test_zstd_manifest_raises_clearly():
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).save(1, _tree(), blocking=True)
        step_dir = os.path.join(d, "step_1")
        os.replace(os.path.join(step_dir, "meta.msgpack.zlib"),
                   os.path.join(step_dir, "meta.msgpack.zst"))
        with pytest.raises(ValueError, match="zstd"):
            Checkpointer(d).restore(_tree())


MSGPACK_CASES = [
    {"step": 3, "codec": "zlib", "keys": ["a", "nest/b"], "n": None, "t": True,
     "f": False, "shapes": {"a": [2, 3], "s": []}},
    [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
     -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
    "x" * 31, "y" * 32, "z" * 255, "w" * 256, "v" * 70000, "é✓ unicode",
    list(range(16)), list(range(70000)), {str(i): i for i in range(16)},
    {str(i): [i, None] for i in range(70000)}, [], {},
]


@pytest.mark.parametrize("obj", MSGPACK_CASES, ids=range(len(MSGPACK_CASES)))
def test_msgpack_lite_matches_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj) == want
    assert msgpack_lite.unpackb(want) == obj
    assert msgpack.unpackb(msgpack_lite.packb(obj), raw=False) == obj


def test_msgpack_lite_refuses_other_types():
    with pytest.raises(TypeError):
        msgpack_lite.packb({"x": {1, 2}})
    with pytest.raises(ValueError, match="unsupported"):
        msgpack_lite.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
