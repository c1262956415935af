"""The port's partition specs (``repro_torch.sharding``) against the
reference's (``repro.sharding.specs``), leaf for leaf: the reference's
``tests/test_sharding.py`` cases under their own names through both
packages, and for every architecture × policy × dp layout the port's spec
of every parameter equals the reference's PartitionSpec entry for entry
(the reference's tree from ``jax.eval_shape(init_params)``, the port's from
its own init on the meta device). The same for ``opt_state_specs``,
``batch_specs`` and ``decode_state_specs`` (batch 1 and 4, reduced
configs); ``local_shape`` against JAX's shard shape; ``placements`` on a
16 × 16 mesh of a fake process group; ``shard_tree`` slicing against numpy
slices."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.optim import init_opt_state as jinit_opt_state
from repro.sharding import specs as jspecs

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import MetaGenerator
from repro_torch.models import init_decode_state, init_params
from repro_torch.optim import init_opt_state
from repro_torch.sharding import (P, batch_specs, decode_state_specs,
                                  local_shape, opt_state_specs, param_specs,
                                  placements)
from repro_torch.tree import leaves_with_paths

AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


@functools.lru_cache(maxsize=None)
def _jparams(arch, reduced=False):
    cfg = (jget_reduced if reduced else jget_config)(arch)
    return cfg, jax.eval_shape(lambda k: jinit_params(cfg, k), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _params(arch, reduced=False):
    cfg = (get_reduced if reduced else get_config)(arch)
    return cfg, init_params(cfg, MetaGenerator())


def _jflat(spec_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            tuple(spec) for path, spec in flat}


def _flat(spec_tree):
    return {p: tuple(s) for p, s in leaves_with_paths(spec_tree)}


def _check_divisible(tree, spec_tree, arch, policy):
    shapes = {p: tuple(t.shape) for p, t in leaves_with_paths(tree)}
    specs = _flat(spec_tree)
    assert set(shapes) == set(specs)
    for path, spec in specs.items():
        local_shape(shapes[path], spec, AXIS_SIZES)      # raises if it does not tile


# ------------------------------------------- the reference's cases, both packages

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("policy", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("dp", [("data",), ("pod", "data")])
def test_param_specs_divisible(arch, policy, dp):
    jcfg, jsds = _jparams(arch)
    cfg, params = _params(arch)
    want = _jflat(jspecs.param_specs(jcfg, jsds, policy=policy, dp=dp,
                                     axis_sizes=AXIS_SIZES))
    got = param_specs(cfg, params, policy=policy, dp=dp, axis_sizes=AXIS_SIZES)
    assert _flat(got) == want
    _check_divisible(params, got, arch, policy)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b", "mamba2-1.3b"])
def test_opt_specs_structure(arch):
    jcfg, jsds = _jparams(arch)
    cfg, params = _params(arch)
    ospec = opt_state_specs(cfg, params, axis_sizes=AXIS_SIZES)
    jospec = jspecs.opt_state_specs(jcfg, jsds, axis_sizes=AXIS_SIZES)
    assert set(ospec) == {"m", "v", "step"}
    assert ospec["step"] == P() and tuple(jospec["step"]) == ()
    for part in ("m", "v"):
        assert _flat(ospec[part]) == _jflat(jospec[part])
    _check_divisible(params, ospec["m"], arch, "zero1")


def test_tp_shards_model_axis_where_it_matters():
    cfg, params = _params("llama3.2-1b")
    specs = param_specs(cfg, params, policy="tp", axis_sizes=AXIS_SIZES)
    assert "model" in specs["blocks"]["ffn"]["up"]
    assert "model" in specs["blocks"]["ffn"]["down"]
    assert "model" in specs["blocks"]["attn"]["wq"]
    assert "model" in specs["embed"]["tok"]


def test_nondivisible_heads_replicated_not_split():
    cfg, params = _params("qwen3-14b")                  # 40 heads % 16 != 0
    specs = param_specs(cfg, params, policy="tp", axis_sizes=AXIS_SIZES)
    assert "model" not in specs["blocks"]["attn"]["wq"]
    assert "model" in specs["blocks"]["ffn"]["up"]


def test_batch_specs_fields():
    bs = batch_specs(get_config("llava-next-mistral-7b"), dp=("pod", "data"))
    assert set(bs) == {"tokens", "labels", "vision_embeds"}
    assert bs["tokens"][0] == ("pod", "data")


# ------------------------------------------------- every tree, leaf for leaf

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dp", [("data",), ("pod", "data")])
def test_opt_and_batch_specs_equal_reference(arch, dp):
    jcfg, jsds = _jparams(arch)
    cfg, params = _params(arch)
    jopt = jax.eval_shape(lambda p: jinit_opt_state(p), jsds)
    opt = init_opt_state(params)
    assert sorted(p for p, _ in leaves_with_paths(opt)) == \
        sorted(_jflat(jax.tree.map(lambda _: JP(), jopt)))
    got = opt_state_specs(cfg, params, dp=dp, axis_sizes=AXIS_SIZES)
    want = jspecs.opt_state_specs(jcfg, jsds, dp=dp, axis_sizes=AXIS_SIZES)
    assert _flat(got) == _jflat(want)
    assert _flat(batch_specs(cfg, dp=dp)) == _jflat(jspecs.batch_specs(jcfg, dp=dp))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("batch", [1, 4])
def test_decode_state_specs_equal_reference(arch, batch):
    jcfg, jsds = _jparams(arch, reduced=True)
    cfg, params = _params(arch, reduced=True)
    S = 64
    enc = (jax.ShapeDtypeStruct((batch, jcfg.enc_ctx, jcfg.d_model), jnp.bfloat16)
           if jcfg.enc_dec else None)
    jstate = jax.eval_shape(lambda p, e: jinit_decode_state(jcfg, p, batch, S, enc_out=e),
                            jsds, enc)
    enc_out = (torch.empty((batch, cfg.enc_ctx, cfg.d_model), dtype=torch.bfloat16,
                           device="meta") if cfg.enc_dec else None)
    state = init_decode_state(cfg, batch, S, device="meta",
                              params=params if cfg.enc_dec else None, enc_out=enc_out)
    for dp in (("data",), ("pod", "data")):
        want = _jflat(jspecs.decode_state_specs(jcfg, jstate, dp=dp, batch=batch))
        got = _flat(decode_state_specs(cfg, state, dp=dp, batch=batch))
        assert got == want, (arch, batch, dp)
    jshapes = {p: tuple(s.shape) for p, s in _flat_leaves(jstate).items()}
    shapes = {p: tuple(getattr(t, "shape", ())) for p, t in leaves_with_paths(state)}
    assert shapes == jshapes


def _flat_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in flat}


# ------------------------------------------------------- shapes and placements

@pytest.mark.parametrize("arch", ["llama3.2-1b", "grok-1-314b", "mamba2-1.3b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("policy", ["tp", "fsdp_tp"])
def test_local_shape_equals_jax_shard_shape(arch, policy):
    """``local_shape`` against ``NamedSharding.shard_shape`` on an abstract
    2 × 16 × 16 mesh (no devices needed)."""
    from jax.sharding import AbstractMesh, NamedSharding
    jcfg, jsds = _jparams(arch)
    cfg, params = _params(arch)
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    jsp = jspecs.param_specs(jcfg, jsds, policy=policy, dp=("pod", "data"),
                             axis_sizes=AXIS_SIZES)
    sp = param_specs(cfg, params, policy=policy, dp=("pod", "data"), axis_sizes=AXIS_SIZES)
    shapes = {p: tuple(t.shape) for p, t in leaves_with_paths(params)}
    for path, spec in _jflat(jsp).items():
        want = NamedSharding(mesh, JP(*spec)).shard_shape(shapes[path])
        assert local_shape(shapes[path], _flat(sp)[path], AXIS_SIZES) == tuple(want), path


def test_placements_on_a_fake_16x16_mesh():
    """Shard / Replicate per mesh dim, a dim split over two axes Shard on
    both, out-of-order axes refused."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=512)
    try:
        mesh = DeviceMesh("cpu", torch.arange(512).reshape(2, 16, 16),
                          mesh_dim_names=("pod", "data", "model"))
        assert placements(P(("pod", "data"), None, "model"), mesh) == \
            [Shard(0), Shard(0), Shard(2)]
        assert placements(P(None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]
        assert placements(P(), mesh) == [Replicate()] * 3
        with pytest.raises(ValueError, match="order"):
            placements(P(("data", "pod")), mesh)
    finally:
        dist.destroy_process_group()


def test_shard_tree_slices_like_numpy(tmp_path):
    """``shard_tree`` on a 2 × 2 mesh of a one-rank-at-a-time fake group:
    each rank's local shard is the numpy slice of the full array."""
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.sharding import shard_tree
    full = {"w": np.arange(8 * 6, dtype=np.float32).reshape(8, 6),
            "b": torch.arange(8, dtype=torch.bfloat16), "pos": 3}
    specs = {"w": P("data", "model"), "b": P(("data", "model")), "pos": P()}
    for rank in range(4):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
        try:
            mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                              mesh_dim_names=("data", "model"))
            placed = shard_tree(full, specs, mesh)
            d, m = divmod(rank, 2)
            assert isinstance(placed["w"], DTensor) and placed["w"].shape == (8, 6)
            np.testing.assert_array_equal(placed["w"].to_local().numpy(),
                                          full["w"][d * 4:(d + 1) * 4, m * 3:(m + 1) * 3])
            assert torch.equal(placed["b"].to_local(), full["b"][rank * 2:(rank + 1) * 2])
            assert placed["pos"] == 3
        finally:
            dist.destroy_process_group()
