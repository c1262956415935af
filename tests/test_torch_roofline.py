"""The port's roofline (``repro_torch.roofline``) against the H100's peaks:
the reference's ``tests/test_roofline.py`` cases that do not depend on HLO
(terms and bottleneck, ``model_flops``), the counted matmul FLOPs of a
reduced llama3.2-1b train step against an analytic count, each kernel's
``cost`` against three bounds of the port's kernel table (PERF.md), the
kernels' meta branches recording that cost, and DTensor's collectives on a
fake (2, 4) mesh against the reference's ring bytes."""
import pytest
import torch

from repro.roofline import Roofline as JRoofline
from repro.roofline import model_flops as jmodel_flops
from repro.roofline.analyze import parse_collectives

from repro_torch.configs import OptimizerConfig, TrainConfig, get_reduced
from repro_torch.device import MetaGenerator
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import Impl, init_params
from repro_torch.models.layers import padded_vocab
from repro_torch.optim import init_opt_state
from repro_torch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS, Roofline, bound, count, model_flops
from repro_torch.runtime.steps import make_train_step


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_roofline_terms_and_bottleneck():
    r = Roofline(flops=989e12, hbm_bytes=3.35e12 / 2, collective_bytes=0,
                 n_collectives=0, by_kind={})
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 0.5) < 1e-9
    assert r.bottleneck == "compute"
    assert r.t_bound == r.t_compute
    # FLOPs by dtype over each dtype's peak (f32 without TF32: 67 TFLOP/s)
    r = Roofline(flops=989e12 + 67e12, hbm_bytes=0, collective_bytes=450e9 * 3,
                 n_collectives=1, by_kind={"all-reduce": 450e9 * 3},
                 flops_by_dtype={"bf16": 989e12, "f32": 67e12})
    assert abs(r.t_compute - 2.0) < 1e-9 and abs(r.t_collective - 3.0) < 1e-9
    assert r.bottleneck == "collective" and abs(r.roofline_fraction() - 0.6) < 1e-9
    assert (PEAK_FLOPS["bf16"], PEAK_FLOPS["f32"], HBM_BW, LINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)
    # the reference's dict keys are all there
    j = JRoofline(flops=1.0, hbm_bytes=1.0, collective_bytes=0, n_collectives=0, by_kind={})
    assert set(j.to_dict()) <= set(r.to_dict())


def test_model_flops():
    assert model_flops(1_000_000, 100, "train") == 6e8
    assert model_flops(1_000_000, 100, "prefill") == 2e8
    for kind in ("train", "prefill", "decode"):
        assert model_flops(123_457, 4096, kind) == jmodel_flops(123_457, 4096, kind)


def test_counted_train_step_matmul_flops_are_analytic():
    """Reduced llama3.2-1b, B 2 × S 32, plain attention, no remat, f32: the
    counted FLOPs are 3× the forward's matmuls (each product's backward is
    two of its size): the blocks' projections and FFN, the tied LM head,
    and the plain attention's full (S × S) score and value products."""
    cfg = get_reduced("llama3.2-1b")
    B, S = 2, 32
    params = init_params(cfg, MetaGenerator())
    opt = init_opt_state(params)
    opt["step"] = torch.zeros((), dtype=torch.int32)
    batch = {"tokens": _m(B, S, dtype=torch.int32), "labels": _m(B, S, dtype=torch.int32)}
    tcfg = TrainConfig(microbatch_size=B, dtype="float32",
                       optimizer=OptimizerConfig(total_steps=10))
    step = make_train_step(cfg, tcfg, Impl(attention="plain"))
    _, cost = count(step, params, opt, batch)
    D, H, Hkv, Dh, F, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.d_ff, cfg.num_layers)
    T = B * S
    per_layer = D * (H + 2 * Hkv) * Dh + H * Dh * D + 3 * D * F
    forward = 2 * T * (L * per_layer + D * padded_vocab(cfg.vocab_size)) \
        + L * 4 * B * H * S * S * Dh
    want = 3 * forward
    assert abs(cost.flops - want) / want < 0.01, (cost.flops, want)
    assert cost.kernels == {}                   # the plain attention runs no kernel


@pytest.mark.parametrize("case,want_ms", [
    ("flash (4, 2048, 32/8, 64)", 0.0695),
    ("decode (8, 1024, 8, 64), 32 q heads", 0.0050),
    ("ssd (4, 2048, 64, 64), N 128", 0.0444)])
def test_kernel_costs_reproduce_the_kernel_tables_bounds(case, want_ms):
    if case.startswith("flash"):
        c = fa.cost(_m(4, 2048, 32, 64), _m(4, 2048, 8, 64))
    elif case.startswith("decode"):
        c = da.cost(_m(8, 1, 32, 64), _m(8, 1024, 8, 64), _m(8, 1024, dtype=torch.int32))
    else:
        c = ss.cost(_m(4, 2048, 64, 64), _m(4, 2048, 64, dtype=torch.float32),
                    _m(4, 2048, 1, 128))
    ms, _ = bound(c["bytes"], c["flops"], "bf16")
    assert round(ms, 4) == want_ms, (case, ms)


def test_kernel_meta_branches_record_their_cost():
    """On the meta device the entry points launch nothing, return empty
    results of the kernels' shapes and record the kernel's cost, forward
    and backward; the CUDA launch counts do not move."""
    before = ops.LAUNCHES.snapshot()
    q = _m(2, 64, 4, 16).requires_grad_(True)
    k = _m(2, 64, 2, 16).requires_grad_(True)
    v = _m(2, 64, 2, 16).requires_grad_(True)
    pos = torch.empty((2, 64), dtype=torch.int32, device="meta")

    def run():
        out = ops.attention(q, k, v, pos, pos)
        torch.autograd.grad(out.float().sum(), (q, k, v))
        x = _m(2, 64, 4, 8)
        y, final = ops.ssd(x, _m(2, 64, 4, dtype=torch.float32),
                           _m(4, dtype=torch.float32), _m(2, 64, 1, 16), _m(2, 64, 1, 16),
                           _m(4, dtype=torch.float32), chunk=32)
        assert y.shape == x.shape and final.shape == (2, 4, 8, 16)
        d = ops.decode_attention(_m(2, 1, 4, 16), k.detach(), v.detach(),
                                 pos[:, :1], pos)
        assert d.shape == (2, 1, 4, 16) and d.device.type == "meta"
        return out
    out, cost = count(run)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert {k: v["launches"] for k, v in cost.kernels.items()} == {
        "flash_attention": 1, "flash_attention_bwd": 1, "ssd_scan": 1,
        "decode_attention": 1}
    assert cost.kernels["flash_attention"]["flops"] == \
        fa.cost(q, k, lse=True)["flops"]
    assert cost.kernels["flash_attention_bwd"]["bytes"] == fa.cost_bwd(q, k)["bytes"]
    assert ops.LAUNCHES.snapshot() == before


def test_collectives_count_the_reference_ring_bytes():
    """An all-reduce, an all-gather and a reduce-scatter over the 4-wide
    dim of a fake (2, 4) mesh (DTensor redistributions of meta shards)
    move the bytes the reference's ``parse_collectives`` gives the same
    HLO collectives."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))

        def dt(local, placements):
            return DTensor.from_local(local, mesh, placements, run_check=False)
        full = _m(8, 16, dtype=torch.float32)
        cases = {
            "all-reduce": (lambda: dt(full, [Replicate(), Partial()])
                           .redistribute(mesh, [Replicate(), Replicate()]),
                           "f32[8,16]"),
            "all-gather": (lambda: dt(_m(2, 16, dtype=torch.float32),
                                      [Replicate(), Shard(0)])
                           .redistribute(mesh, [Replicate(), Replicate()]), "f32[8,16]"),
            "reduce-scatter": (lambda: dt(full, [Replicate(), Partial()])
                               .redistribute(mesh, [Replicate(), Shard(0)]), "f32[2,16]"),
        }
        for kind, (fn, result) in cases.items():
            _, cost = count(fn)
            hlo = (f"  %c = {result}{{1,0}} {kind}(f32[8,16]{{1,0}} %x), "
                   f"replica_groups={{{{0,1,2,3}},{{4,5,6,7}}}}")
            (op,) = parse_collectives(hlo, 8)
            assert cost.n_coll == 1 and cost.coll_by_kind == {kind: op.moved_bytes}, \
                (kind, cost.coll_by_kind, op)
    finally:
        dist.destroy_process_group()
