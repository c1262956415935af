"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) on the CPU: ``input_specs``,
``apply_opts`` and ``opts_tag`` for every cell and option; ``run_cell`` on
reduced configs at small shapes on meshes 1, 2x2 and 16x16, whose
per-device bytes of parameters, gradients and moments equal the sum over
the reference's shard shapes; activation bytes on the meta device equal
those of the same microbatch run on the CPU with the same hooks; one
full-width cell (llama3.2-1b train_4k on one card)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_reduced as jget_reduced
from repro.models import init_params as jinit_params
from repro.sharding import specs as jspecs

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, ShapeConfig, get_config,
                                 get_reduced)
from repro_torch.launch import dryrun
from repro_torch.models import Impl, init_params, loss_fn
from repro_torch.tree import leaves


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module (its import sets XLA_FLAGS for a
    512-device host; put back as it was)."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return ref


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_references(jdry, arch):
    for shape in SHAPES_BY_NAME:
        got = dryrun.input_specs(arch, shape)
        want = jdry.input_specs(arch, shape)
        assert set(got) == set(want)
        for name, t in got.items():
            assert tuple(t.shape) == tuple(want[name].shape) and t.device.type == "meta"
            assert str(t.dtype).removeprefix("torch.") == str(jnp.dtype(want[name].dtype))


OPTS = [{}, {"moe_group": 4096}, {"moe_group": True}, {"moe_group": 256},
        {"pad_heads": True}, {"zero_grads": True},
        {"moe_group": 512, "pad_heads": True, "zero_grads": True}]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_apply_opts_and_tags_equal_the_references(jdry, arch):
    for kind in ("train", "prefill", "decode"):
        for opts in OPTS:
            cfg, _ = dryrun.apply_opts(get_config(arch), dryrun.IMPL, opts, kind=kind)
            jcfg, _ = jdry.apply_opts(jdry.get_config(arch), jdry.IMPL, opts, kind=kind)
            assert (cfg.pad_q_heads, cfg.pad_kv_heads) == (jcfg.pad_q_heads, jcfg.pad_kv_heads)
            assert (cfg.moe.group_size if cfg.moe else None) == \
                (jcfg.moe.group_size if jcfg.moe else None), (arch, kind, opts)
    for opts in OPTS + [{"kv_chunk": 256}, {"anchor": ("data",)},
                        {"kv_chunk": 64, "anchor": ("data",), "pad_heads": True}]:
        assert dryrun.opts_tag(opts) == jdry.opts_tag(opts)
    for knob in ({"kv_chunk": 256}, {"anchor": ("data",)}):
        with pytest.raises(ValueError, match="no counterpart"):
            dryrun.apply_opts(get_config(arch), dryrun.IMPL, knob)


def _ref_state_bytes(arch, policy, sizes, pdt, odt, gdt, grad_policy=None):
    """Per-device bytes of parameters, gradients and moments from the
    reference's specs and shard shapes on a mesh of ``sizes``; the
    gradients split by ``grad_policy``'s specs where one is given (the
    reference's ``grad_specs`` under ``zero_grads``)."""
    cfg = jget_reduced(arch)
    sds = jax.eval_shape(lambda k: jinit_params(cfg, k), jax.random.PRNGKey(0))
    names = tuple(sizes)
    mesh = AbstractMesh(tuple(sizes.values()), names)
    dp = tuple(n for n in names if n != "model")
    pspecs = jspecs.param_specs(cfg, sds, policy=policy, dp=dp, axis_sizes=sizes)
    ospecs = jspecs.opt_state_specs(cfg, sds, dp=dp, axis_sizes=sizes)["m"]
    gspecs = pspecs if grad_policy is None else jspecs.param_specs(
        cfg, sds, policy=grad_policy, dp=dp, axis_sizes=sizes)

    def total(specs, itemsize):
        shapes = jax.tree.leaves(sds)
        flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(l.shape))) * itemsize
                   for l, s in zip(shapes, flat))
    return {"params": total(pspecs, pdt), "grads": total(gspecs, gdt),
            "moments": 2 * total(ospecs, odt)}


@pytest.mark.parametrize("arch,mesh,B", [("llama3.2-1b", "1", 4),
                                         ("llama3.2-1b", "2x2", 8),
                                         ("llama3.2-1b", "16x16", 32),
                                         ("mixtral-8x7b", "2x2", 8)])
def test_run_cell_state_bytes_equal_the_references_shards(arch, mesh, B):
    shape = ShapeConfig("small", 16, B, "train")
    r = dryrun.run_cell(arch, "train_4k", mesh=mesh, save=False, cfg=get_reduced(arch),
                        shape=shape)
    assert r["status"] == "ok" and r["mesh"] == mesh
    shape_dims, axes = dryrun.MESHES[mesh]
    sizes = dict(zip(axes, shape_dims)) if axes else {"data": 1, "model": 1}
    want = _ref_state_bytes(arch, dryrun.TRAIN_POLICY.get(arch, "tp"), sizes, 4, 4, 4)
    got = {part: sum(r["memory"][part].values()) for part in want}
    assert got == want
    assert r["state_bytes"] == sum(want.values())
    roof = r["roofline"]
    assert roof["flops"] > 0 and r["act_bytes"] > 0
    assert (roof["collective_bytes"] > 0) == (mesh != "1")
    assert r["kernels"]["flash_attention"]["launches"] > 0
    assert r["kernels"]["flash_attention_bwd"]["launches"] > 0


@pytest.mark.parametrize("mesh,B", [("2x2", 8), ("16x16", 32)])
def test_zero_grads_splits_the_gradients_as_fsdp_tp(mesh, B):
    """``zero_grads`` under the ``tp`` policy: each gradient is split over
    the data axes by the ``fsdp_tp`` specs, as the reference's
    ``grad_specs`` split it, so a device holds fewer gradient bytes than in
    the base cell and reduces them by reduce-scatter where the base cell
    all-reduces them; parameters and moments are placed as in the base."""
    arch = "llama3.2-1b"
    assert dryrun.TRAIN_POLICY.get(arch, "tp") == "tp"
    shape = ShapeConfig("small", 16, B, "train")
    base, zg = (dryrun.run_cell(arch, "train_4k", mesh=mesh, save=False,
                                cfg=get_reduced(arch), shape=shape, opts=opts)
                for opts in ({}, {"zero_grads": True}))
    assert (base["opts"], zg["opts"]) == ("base", "zgrad")
    shape_dims, axes = dryrun.MESHES[mesh]
    want = _ref_state_bytes(arch, "tp", dict(zip(axes, shape_dims)), 4, 4, 4,
                            grad_policy="fsdp_tp")
    got = {part: sum(zg["memory"][part].values()) for part in want}
    assert got == want
    assert got["grads"] < sum(base["memory"]["grads"].values())
    assert zg["memory"]["params"] == base["memory"]["params"]
    assert zg["memory"]["moments"] == base["memory"]["moments"]
    kinds = {name: r["roofline"]["by_kind"] for name, r in (("base", base), ("zg", zg))}
    assert kinds["zg"].get("reduce-scatter", 0) > kinds["base"].get("reduce-scatter", 0)
    assert kinds["zg"]["all-reduce"] < kinds["base"]["all-reduce"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b", "mixtral-8x7b"])
@pytest.mark.parametrize("remat", [False, True])
def test_meta_activation_bytes_equal_the_cpus(arch, remat):
    """The bytes autograd saves for one microbatch's backward, counted on
    the meta device and on the CPU (real tensors, the plain versions of the
    kernels) with the same hooks: equal."""
    cfg = get_reduced(arch)
    impl = Impl(remat=remat)
    B, S = 2, 24
    meta = dryrun.count_step(cfg, "train", B, S, micro=B, dtype=torch.float32, impl=impl,
                             costs=False)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    for p in leaves(params):
        p.requires_grad_(True)
    cpu = dryrun.saved_bytes(lambda: loss_fn(cfg, params, batch, impl=impl,
                                             dtype=torch.float32), exclude=leaves(params))
    assert meta["act_bytes"] == cpu > 0


def test_full_width_llama_train_cell_on_one_card():
    r = dryrun.run_cell("llama3.2-1b", "train_4k", save=False)
    cfg = get_config("llama3.2-1b")
    n = sum(t.numel() for t in leaves(init_params(cfg, dryrun.MetaGenerator())))
    assert r["status"] == "ok" and r["n_micro"] == 128
    assert r["memory"]["params"] == {"float32": 4 * n}
    assert r["state_bytes"] == 16 * n
    assert r["fits"] and r["fits_depth"] >= cfg.num_layers
    assert r["capacity_bytes"] == 80 * 10 ** 9 and "H100" in r["card"]
    assert r["kernels"]["flash_attention"]["launches"] == 2 * 16 * 128   # remat: twice
    assert r["kernels"]["flash_attention_bwd"]["launches"] == 16 * 128
    assert 0.5 < r["useful_flops_ratio"] < 1.0
    assert r["model_flops_global"] == 6 * cfg.active_param_count() * 256 * 4096


def test_serving_cells_fit_and_give_a_depth():
    """On one card every kind reports ``fits`` and ``fits_depth``: a
    decode cell's cache grows with depth as its weights do."""
    cfg = get_reduced("llama3.2-1b")
    for shape in ("prefill_32k", "decode_32k"):
        r = dryrun.run_cell("llama3.2-1b", shape, save=False, cfg=cfg)
        assert r["fits"] and r["fits_depth"] >= cfg.num_layers
        per_layer = r["bytes_per_unit"]
        assert per_layer > 0 and r["need_bytes"] == r["state_bytes"] + r["act_bytes"]


def test_run_cell_in_a_subprocess_beside_a_default_group(tmp_path):
    """A caller that holds a default process group gets a mesh cell from a
    fresh interpreter (a fake group cannot sit beside it)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        r = dryrun.run_cell("whisper-tiny", "decode_32k", mesh="2x2", save=False)
    finally:
        dist.destroy_process_group()
    assert r["status"] == "ok" and r["devices"] == 4 and r["mesh"] == "2x2"
    assert r["kernels"]["decode_attention"]["launches"] == 8
