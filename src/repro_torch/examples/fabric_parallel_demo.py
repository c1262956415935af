"""MPKLink fabric parallelism showcase — four ranks.

Every distributed pattern of the port running over guarded MPKLink channels
between ranks (``torch.distributed`` over gloo, started by
``launch.world.run_world``; on the card all four ranks share ``cuda:0`` and
the fabric stages each exchange through pinned host buffers), each held
against its one-rank oracle:

  1. SP  — ring attention: sequence-sharded Q/K/V, K/V rotating through a
           protected neighbor channel (vs full attention)
  2. EP  — expert-parallel MoE: tokens dispatched between expert-owning
           ranks through a guarded all_to_all (vs the dense dispatch)
  3. PP  — GPipe pipeline: 4 stages handing activations through the
           channel each tick (vs the one-rank layer stack)
  4. DP  — int8 + error-feedback compressed gradient reduce (vs the exact
           mean)

The ranks start from a forkserver and re-import the main module, so a
script that calls :func:`main` keeps its top level under
``if __name__ == "__main__":``, as this one does.

    python -m repro_torch.examples.fabric_parallel_demo [--device cuda]
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve
from repro_torch.examples._common import check, kernel_tiled, parser

WORLD = 4
RING = dict(B=2, S=64, H=4, Hkv=2, Dh=64)      # Dh: flash's smallest tile
PIPE = dict(layers=8, n_micro=4, mb=2, S=16)
MOE_TOKENS = 16
TOL = 1e-4                      # f32, against max(1, |oracle|)


def _err(got, want) -> float:
    """Max abs error of ``got`` against ``want``, over max(1, max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err / max(1.0, want.float().abs().max().item())


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def demo_ring_attention(rank, world, fab, device):
    from repro_torch.core.ring_attention import ring_attention
    from repro_torch.kernels.ref import attention_ref
    chan, key = fab.establish("sp-kv", "x")
    B, S, H, Hkv, Dh = (RING[k] for k in ("B", "S", "H", "Hkv", "Dh"))
    g = _gen(device, 0)
    q = torch.randn(B, S, H, Dh, generator=g, device=device)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=device)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=device)
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    blk = slice(rank * S // world, (rank + 1) * S // world)
    ql, kl, vl, pl = (t[:, blk].contiguous() for t in (q, k, v, pos))
    out, ok = ring_attention(fab, chan, key, ql, kl, vl, pl, pl, causal=True)
    ref = attention_ref(q, k, v, pos, pos, causal=True)[:, blk]
    return {"err": _err(out, ref), "ok": int(ok.item())}


def demo_moe_ep(rank, world, fab, device):
    from repro_torch.configs import MoEConfig, get_reduced, replace
    from repro_torch.models.moe import apply_moe, init_moe_stack
    from repro_torch.models.moe_ep import apply_moe_ep, split_expert_weights
    from repro_torch.tree import map_tree
    cfg = replace(get_reduced("mixtral-8x7b"),
                  moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=16.0))
    g = _gen(device, 1)
    w = map_tree(lambda a: a[0], init_moe_stack(cfg, g, 1))
    x = torch.randn(world, MOE_TOKENS, cfg.d_model, generator=g, device=device)
    chan, key = fab.establish("ep-dispatch", "x")
    y, _ = apply_moe_ep(cfg, split_expert_weights(w, world, rank),
                        x[rank:rank + 1], fabric=fab, chan=chan, key=key)
    dense = replace(cfg, moe=replace(cfg.moe, group_size=MOE_TOKENS))
    y_ref, _ = apply_moe(dense, w, x[rank:rank + 1])
    return {"err": _err(y, y_ref), "experts": cfg.moe.num_experts}


def demo_pipeline(rank, world, fab, device):
    from repro_torch.configs import get_reduced, replace
    from repro_torch.models.transformer import Impl, apply_stack, init_stack
    from repro_torch.runtime.pipeline import pipeline_apply, stage_split
    from repro_torch.tree import map_tree
    cfg = replace(kernel_tiled(get_reduced("llama3.2-1b")), num_layers=PIPE["layers"])
    n_micro, mb, S = PIPE["n_micro"], PIPE["mb"], PIPE["S"]
    g = _gen(device, 2)
    stacked = init_stack(cfg, g, cfg.num_layers)
    x = torch.randn(n_micro, mb, S, cfg.d_model, generator=g, device=device)
    positions = torch.arange(S, dtype=torch.int32, device=device)[None].expand(mb, S)
    ref = torch.stack([apply_stack(cfg, stacked, x[i], positions=positions,
                                   impl=Impl())[0] for i in range(n_micro)])
    chan, key = fab.establish("pp-handoff", "x")
    local = map_tree(lambda a: a[rank], stage_split(stacked, world))
    out, ok = pipeline_apply(cfg, local, x, fabric=fab, chan=chan, key=key,
                             impl=Impl())
    return {"err": _err(out, ref), "ok": int(ok.item()),
            "ticks": n_micro + world - 1}


def demo_compressed_dp(rank, world, device):
    import torch.distributed as dist
    from repro_torch.optim import compressed_reduce
    g = torch.randn(world, 64, 16, generator=_gen(device, 3), device=device)
    rows = g.shape[1] // world
    out, ef = compressed_reduce(g[rank], torch.zeros(rows, 16, device=device),
                                dist.group.WORLD)
    exact = g.mean(0)
    worst = 0.0                 # error in int8 steps of each rank's shard
    for j in range(world):
        shard = exact[j * rows:(j + 1) * rows]
        step = shard.abs().max().item() / 127.0
        worst = max(worst, (out[j * rows:(j + 1) * rows] - shard).abs().max().item()
                    / step)
    return {"err": (out - exact).abs().max().item(), "int8_steps": worst,
            "residual": ef.abs().max().item()}


def rank_main(rank: int, world: int, device: str) -> dict:
    """One rank: the four demos in turn, with this rank's kernel launches."""
    from repro_torch.core.fabric import MPKLinkFabric
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    dev = resolve(device)
    mesh = make_test_mesh((world,), ("x",), device=dev.type)
    fab = MPKLinkFabric(mesh, guard=True)
    before = ops.LAUNCHES.snapshot()
    with torch.no_grad():
        out = {"ring": demo_ring_attention(rank, world, fab, dev),
               "moe": demo_moe_ep(rank, world, fab, dev),
               "pipeline": demo_pipeline(rank, world, fab, dev),
               "dp": demo_compressed_dp(rank, world, dev)}
    out["launches"] = {k: v - before[k] for k, v in ops.LAUNCHES.snapshot().items()}
    return out


def main(argv=None):
    from repro_torch.launch.world import run_world
    args = parser(__doc__).parse_args(argv)
    device = resolve(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build()                  # ranks load the parent's libraries
    print(f"ranks: {WORLD}  mesh: {WORLD}×('x')  backend: gloo  guard: MAC on  "
          f"device: {device}\n")
    t0 = time.perf_counter()
    ranks = run_world(rank_main, WORLD, str(device), device=device.type,
                      timeout=600)
    wall = time.perf_counter() - t0

    def worst(name, key):
        return max(r[name][key] for r in ranks)

    ring_ok = all(r["ring"]["ok"] for r in ranks)
    print(f"1. SP ring attention : {WORLD}-way seq-sharded, max|Δ| vs oracle = "
          f"{worst('ring', 'err'):.2e}, guard ok={int(ring_ok)}")
    check(ring_ok and worst("ring", "err") <= TOL, "ring attention")
    print(f"2. EP MoE dispatch   : {ranks[0]['moe']['experts']} experts on "
          f"{WORLD} ranks, max|Δ| vs dense = {worst('moe', 'err'):.2e}")
    check(worst("moe", "err") <= TOL, "expert-parallel MoE")
    pipe_ok = all(r["pipeline"]["ok"] for r in ranks)
    print(f"3. PP GPipe          : {WORLD} stages × {PIPE['n_micro']} microbatches "
          f"({ranks[0]['pipeline']['ticks']} ticks), max|Δ| vs stack = "
          f"{worst('pipeline', 'err'):.2e}, guard ok={int(pipe_ok)}")
    check(pipe_ok and worst("pipeline", "err") <= TOL, "pipeline")
    print(f"4. DP int8+EF reduce : gradient mean, max|Δ| vs exact = "
          f"{worst('dp', 'err'):.2e} ({worst('dp', 'int8_steps'):.3f} int8 "
          f"steps; the int8 leg moves 4× fewer bytes)")
    check(worst("dp", "int8_steps") <= 0.5 + 1e-3
          and min(r["dp"]["residual"] for r in ranks) > 0, "compressed reduce")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    print(f"kernel launches (all ranks): { {k: v for k, v in launches.items() if v} }")
    if device.type == "cuda":
        check(launches["flash_attention"] > 0 and launches["mac_batch"] > 0,
              f"kernel launches {launches}")
    print(f"\nwall {wall:.1f} s")
    print("fabric_parallel_demo OK")
    return launches


if __name__ == "__main__":
    main()
