"""Rank body for the port's elastic-restore test: a module-level function
that ``repro_torch.launch.world.run_world`` runs in every rank of a gloo
world of four on the CPU. It imports numpy, torch and the port only, so a
rank does not import JAX."""
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.device import MetaGenerator
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import init_params
from repro_torch.runtime.elastic import elastic_restore, remesh
from repro_torch.sharding import (P, local_shape, mesh_sizes, param_specs,
                                  placements)
from repro_torch.tree import leaves_with_paths, map_tree

ARCH = "llama3.2-1b"
RESAVED_STEP = 7


def like_tree():
    """The checkpoint's tree shape: reduced llama3.2-1b's parameters (on
    the meta device: only the paths count), an (8, 8) "w" and a bf16 "wb"."""
    cfg = get_reduced(ARCH)
    return cfg, {"params": init_params(cfg, MetaGenerator()),
                 "w": torch.empty((8, 8), device="meta"),
                 "wb": torch.empty((8, 4), dtype=torch.bfloat16, device="meta")}


def spec_tree(cfg, like, mesh):
    return {"params": param_specs(cfg, like["params"], policy="fsdp_tp", mesh=mesh),
            "w": P("data", "model"), "wb": P(("data", "model"), None)}


def _shards(placed, specs, mesh):
    """{path: (local shard as numpy, its shape equals local_shape, its
    placements equal placements(spec))}."""
    sizes = mesh_sizes(mesh)
    spec_of = dict(leaves_with_paths(specs))
    out = {}
    for path, t in leaves_with_paths(placed):
        local = t.to_local()
        ok = (tuple(local.shape) == local_shape(t.shape, spec_of[path], sizes)
              and list(t.placements) == placements(spec_of[path], mesh))
        host = local.view(torch.int16).numpy() if local.dtype == torch.bfloat16 \
            else local.numpy()
        out[path] = (host, ok)
    return out


def elastic_cases(rank: int, world: int, ckpt_dir: str) -> dict:
    """Restore the reference's checkpoint onto a (2, 2) mesh under fsdp_tp;
    rank 0 saves the full arrays again with the port's Checkpointer; then
    after losing two ranks, restore that onto ``remesh(2, tp=2)``'s (1, 2)
    mesh (ranks 2 and 3 build the mesh with the others and hold no shard)."""
    cfg, like = like_tree()
    ck = Checkpointer(ckpt_dir)
    mesh_a = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    specs_a = spec_tree(cfg, like, mesh_a)
    step_a, placed_a = elastic_restore(ck, like, mesh_a, specs_a)
    out = {"step_a": step_a, "coord_a": mesh_a.get_coordinate(),
           "a": _shards(placed_a, specs_a, mesh_a)}
    full = map_tree(lambda t: t.full_tensor(), placed_a)     # all-gathers over gloo
    if rank == 0:
        ck.save(RESAVED_STEP, full, blocking=True)
    dist.barrier()
    mesh_b = remesh(2, tp=2, device="cpu")
    out["coord_b"] = mesh_b.get_coordinate()
    if out["coord_b"] is not None:
        specs_b = spec_tree(cfg, like, mesh_b)
        step_b, placed_b = elastic_restore(ck, like, mesh_b, specs_b)
        out["step_b"] = step_b
        out["b"] = _shards(placed_b, specs_b, mesh_b)
    dist.barrier()
    return out
