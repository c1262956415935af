"""Rank bodies for the port's fabric tests: module-level functions that
``repro_torch.launch.world.run_world`` runs in every rank of a gloo world
on the CPU. Each reads its inputs from an ``.npz`` written by the test
module and returns numpy arrays (this rank's outputs), which the test
holds against the JAX package's outputs for the same inputs.

This module imports numpy, torch and the port only, so a rank does not
import JAX."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced, replace
from repro_torch.convert import params_from_numpy
from repro_torch.core.domains import AccessViolation
from repro_torch.core.fabric import (FABRIC_STATS, MPKLinkFabric, all_to_all,
                                     attach_mac, neighbor_exchange,
                                     psum_guarded, reduce_scatter_ring,
                                     ring_all_gather, verify_mac)
from repro_torch.core.ring_attention import ring_attention
from repro_torch.launch.mesh import dp_axes, make_production_mesh, make_test_mesh
from repro_torch.models.moe_ep import apply_moe_ep, split_expert_weights
from repro_torch.models.transformer import Impl
from repro_torch.optim import compressed_reduce, compressed_tree_reduce
from repro_torch.runtime.elastic import remesh
from repro_torch.runtime.pipeline import pipeline_apply, stage_split
from repro_torch.tree import leaves_with_paths, map_tree

RING = dict(B=2, S=64, H=4, Hkv=2, Dh=16)
RING_CASES = ((True, None), (True, 24), (False, None))
MOE = dict(E=4, B=4, S=16)
MOE_CAPACITIES = (16.0, 1.25)       # loose (nothing drops), the config's own
PIPE = dict(layers=8, n_micro=4, mb=2, S=16)


def moe_config(capacity_factor: float):
    """Reduced mixtral (4 experts: one a rank of four) at a capacity
    factor."""
    cfg = get_reduced("mixtral-8x7b")
    return replace(cfg, moe=replace(cfg.moe, num_experts=MOE["E"],
                                    capacity_factor=capacity_factor))


def pipe_config():
    return replace(get_reduced("llama3.2-1b"), num_layers=PIPE["layers"])


def tree_from_paths(flat: dict, prefix: str) -> dict:
    """{"prefix/a/b": array} → {"a": {"b": array}}."""
    tree: dict = {}
    for path, arr in flat.items():
        if not path.startswith(prefix + "/"):
            continue
        *heads, last = path[len(prefix) + 1:].split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = arr
    return tree


def _local(a: np.ndarray, rank: int, world: int) -> torch.Tensor:
    """This rank's block of dim 0 (shard_map's P("x"))."""
    n = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))


def _raises_before_any_hop(fn) -> bool:
    before = FABRIC_STATS.snapshot()
    try:
        fn()
    except AccessViolation:
        return FABRIC_STATS.snapshot() == before
    return False


def fabric_cases(rank: int, world: int, path: str) -> dict:
    inp = dict(np.load(path))
    mesh = make_test_mesh((world,), ("x",), device="cpu")
    fab = MPKLinkFabric(mesh, guard=True)
    chan, key = fab.establish("tp", "x")
    out = {"seed": np.uint32(chan.seed)}
    x = _local(inp["x"], rank, world)
    for shift in (1, 2, 3):
        y, ok = neighbor_exchange(fab, chan, key, x, shift=shift)
        out[f"ne{shift}"], out[f"ne{shift}_ok"] = y, ok.reshape(1)
    g, ok = ring_all_gather(fab, chan, key, x)
    out["ag"], out["ag_ok"] = g, ok.reshape(1)
    for name in ("rs_int", "rs_float"):
        s, ok = reduce_scatter_ring(fab, chan, key, _local(inp[name], rank, world)[0])
        out[name], out[name + "_ok"] = s[None], ok.reshape(1)
    out["a2a"] = all_to_all(fab, chan, key, _local(inp["a2a"], rank, world),
                            split_axis=1, concat_axis=0)
    out["a2a3"] = all_to_all(fab, chan, key, _local(inp["a2a3"], rank, world)[0],
                             split_axis=0, concat_axis=1)[None]
    out["psum"] = psum_guarded(fab, chan, key, _local(inp["psum"], rank, world))

    # capabilities: a foreign key and a revoked key raise before any hop,
    # in every rank, and the world goes on to a collective that succeeds
    chan2, key2 = fab.establish("other", "x")
    foreign = [_raises_before_any_hop(lambda: f(fab, chan, key2, x))
               for f in (neighbor_exchange, ring_all_gather, psum_guarded)]
    foreign.append(_raises_before_any_hop(
        lambda: all_to_all(fab, chan, key2, x, split_axis=0, concat_axis=0)))
    fab.revoke(chan2)
    revoked = _raises_before_any_hop(lambda: neighbor_exchange(fab, chan2, key2, x))
    out["foreign_refused"] = np.array(foreign)
    out["revoked_refused"] = np.array([revoked])
    out["after_refusals"] = psum_guarded(fab, chan, key, torch.ones(1))

    # a corrupted hop: one flipped bit in a received buffer fails its MAC
    raw, raw_key = fab.establish("raw", "x", guard=False)
    y, _ = neighbor_exchange(fab, raw, raw_key, x)
    mac_y, _ = neighbor_exchange(fab, raw, raw_key,
                                 attach_mac(x, chan.seed).view(torch.int32).reshape(1))
    bad = y.clone()
    bad.view(torch.int32).view(-1)[rank] ^= 1 << (3 + rank)
    out["mac_clean_ok"] = verify_mac(y, mac_y, chan.seed).reshape(1)
    out["mac_flipped_ok"] = verify_mac(bad, mac_y, chan.seed).reshape(1)

    # int8 + error-feedback reduce, two steps, and the tree version
    grp = mesh.get_group("x")
    ef = torch.zeros(inp["ef0"].shape[1:])
    for step in (1, 2):
        o, ef = compressed_reduce(_local(inp[f"cr_g{step}"], rank, world)[0], ef, grp)
        out[f"cr_out{step}"], out[f"cr_ef{step}"] = o[None], ef[None]
    o, ef2 = compressed_reduce(_local(inp["cr_odd"], rank, world)[0],
                               torch.zeros(inp["cr_odd"].shape[1:]), grp)
    out["cr_odd_out"], out["cr_odd_ef"] = o[None], ef2[None]
    tree = {"a": _local(inp["cr_g1"], rank, world)[0],
            "b": {"c": _local(inp["cr_odd"], rank, world)[0]}}
    ef_tree = {"a": torch.zeros(inp["ef0"].shape[1:]),
               "b": {"c": torch.zeros(inp["cr_odd"].shape[1:])}}
    red, new_ef = compressed_tree_reduce(tree, ef_tree, grp)
    out["tree_a"], out["tree_c"] = red["a"][None], red["b"]["c"][None]
    out["tree_ef_a"] = new_ef["a"][None]

    # meshes: 2-D, a channel over its "model" rows, the production shapes
    # refused in a world of four, and remesh
    m2 = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    fab2 = MPKLinkFabric(m2, guard=True)
    row, row_key = fab2.establish("tp", "model")
    out["mesh2_shift"], ok = neighbor_exchange(fab2, row, row_key,
                                               torch.tensor([float(rank)]))
    out["mesh2_ok"] = ok.reshape(1)
    out["mesh2_coord"] = np.array(m2.get_coordinate())
    try:
        make_production_mesh(device="cpu")
        out["production_refused"] = np.array([False])
    except ValueError:
        out["production_refused"] = np.array([True])
    out["dp_axes"] = np.array([dp_axes(False) == ("data",),
                               dp_axes(True) == ("pod", "data")])
    full = remesh(4, tp=2, device="cpu")
    part = remesh(3, tp=2, device="cpu")
    out["remesh_full"] = np.array([full.mesh.shape[0], full.mesh.shape[1],
                                   *full.get_coordinate()])
    coord = part.get_coordinate()
    out["remesh_part"] = np.array([*part.mesh.shape,
                                   -1 if coord is None else coord[1]])
    try:
        remesh(1, tp=2, device="cpu")
        out["remesh_refused"] = np.array([False])
    except RuntimeError:
        out["remesh_refused"] = np.array([True])
    out["world_rank"] = np.array([dist.get_rank()])
    return out


def model_cases(rank: int, world: int, path: str) -> dict:
    inp = dict(np.load(path))
    mesh = make_test_mesh((world,), ("x",), device="cpu")
    out = {}

    # ring attention over a guarded channel, three masks
    fab = MPKLinkFabric(mesh, guard=True)
    chan, key = fab.establish("ring-kv", "x")
    q, k, v = (_local(inp[n].swapaxes(0, 1), rank, world).swapaxes(0, 1).contiguous()
               for n in ("q", "k", "v"))
    pos = _local(inp["pos"].T, rank, world).T.contiguous()
    for i, (causal, window) in enumerate(RING_CASES):
        o, ok = ring_attention(fab, chan, key, q, k, v, pos, pos,
                               causal=causal, window=window)
        out[f"ring{i}"], out[f"ring{i}_ok"] = o, ok.reshape(1)

    # expert-parallel MoE: one expert and one batch row a rank
    w = {n: torch.from_numpy(inp["moe_" + n]) for n in ("router", "gate", "up", "down")}
    fab_ep = MPKLinkFabric(mesh)
    chan_ep, key_ep = fab_ep.establish("moe-dispatch", "x")
    for i, cf in enumerate(MOE_CAPACITIES):
        y, aux = apply_moe_ep(moe_config(cf), split_expert_weights(w, world, rank),
                              _local(inp["moe_x"], rank, world),
                              fabric=fab_ep, chan=chan_ep, key=key_ep)
        out[f"moe{i}"], out[f"moe{i}_drop"] = y, aux["moe_drop_frac"].reshape(1)

    # the GPipe pipeline: forward, then gradients of sum(out²)
    pcfg = pipe_config()
    stacked = params_from_numpy(tree_from_paths(inp, "stack"), device="cpu")
    local = map_tree(lambda a: a[rank].clone().requires_grad_(),
                     stage_split(stacked, world))
    fabp = MPKLinkFabric(mesh, guard=True)
    chan_p, key_p = fabp.establish("stage-handoff", "x")
    xm = torch.from_numpy(inp["pipe_x"])
    outs, ok = pipeline_apply(pcfg, local, xm, fabric=fabp, chan=chan_p,
                              key=key_p, impl=Impl())
    (outs ** 2).sum().backward()
    out["pipe"], out["pipe_ok"] = outs, ok.reshape(1)
    for p, leaf in leaves_with_paths(local):
        out["grad/" + p] = leaf.grad[None]
    return out

