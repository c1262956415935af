"""Elastic scaling and recovery policies (the port of
``repro.runtime.elastic``).

Each planner is a pure decision over a snapshot (no side effects), so a
supervisor's sweeps replay exactly: :func:`plan_gateway_recovery` over a
gateway's health snapshot (``fault.GatewaySupervisor``),
:func:`plan_fleet_scaling` and :func:`plan_outlier_ejection` over a
replica fleet's snapshot (``core.gateway.FleetSupervisor``), and
:func:`plan_remesh` over the count of surviving ranks of a training job:
tensor parallelism (the ``model`` axis) is pinned, since its size is a
property of the model's memory footprint, and the data-parallel axis
shrinks to the whole rows that survive. :func:`remesh` builds that mesh
(a ``DeviceMesh`` over the first dp · tp ranks of the world), and
:func:`elastic_restore` places the latest checkpoint on it: checkpoints
hold full logical arrays keyed by tree path, so any mesh that tiles the
dims loads any checkpoint.
"""
from __future__ import annotations

from typing import Optional, Tuple


def plan_remesh(n_alive_chips: int, tp: int = 16,
                axes=("data", "model")) -> Optional[Tuple[Tuple[int, int], Tuple[str, str]]]:
    """→ ((dp, tp), axes) for the largest mesh the survivors support, or
    None if fewer than one TP row survives."""
    dp = n_alive_chips // tp
    if dp < 1:
        return None
    return (dp, tp), tuple(axes)


def remesh(n_alive_chips: int, tp: int = 16, axes=("data", "model"),
           device="cuda"):
    """The mesh :func:`plan_remesh` chooses, over ranks 0 … dp·tp − 1 of the
    world (every rank calls it; a rank outside the mesh has no
    coordinate in it). Raises RuntimeError if fewer than one TP row
    survives."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve

    plan = plan_remesh(n_alive_chips, tp, axes)
    if plan is None:
        raise RuntimeError(
            f"not enough chips ({n_alive_chips}) for one tp={tp} row")
    (dp, tp), names = plan
    if dp * tp > dist.get_world_size():
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} ranks; the "
                         f"world holds {dist.get_world_size()}")
    return DeviceMesh(resolve(device).type,
                      torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=names)


def elastic_restore(ckpt, like_tree, mesh, spec_tree, step: Optional[int] = None):
    """Restore the latest checkpoint (or ``step``) of ``ckpt`` (a
    ``checkpoint.Checkpointer``) and place it on a (possibly different)
    mesh by ``spec_tree`` (a tree of ``sharding.P``). → (step,
    placed_tree): DTensors whose local shards every rank of the mesh slices
    itself, no collective run."""
    from repro_torch.tree import map_tree
    return ckpt.restore_placed(like_tree, map_tree(lambda s: (mesh, s), spec_tree),
                               step)


def plan_gateway_recovery(health: dict, restartable: set) -> list:
    """Service-level remesh policy (pure decision, no side effects): given
    a gateway health snapshot ({service: {"state", ...}}), decide per
    service what the supervisor should actuate.

      open circuit + restartable → ("restart", name)   epoch bump + re-key
      open circuit, no factory   → ("shed", name)      keep shedding typed
      half_open                  → ("probe", name)     a probe is in flight
      closed                     → no action

    Deterministic and order-stable (sorted by service name) so supervision
    sweeps are replayable in chaos tests."""
    actions = []
    for name in sorted(health):
        state = health[name]["state"]
        if state == "open":
            actions.append(("restart" if name in restartable else "shed",
                            name))
        elif state == "half_open":
            actions.append(("probe", name))
    return actions


def plan_fleet_scaling(snapshot: list, target: int) -> list:
    """Replica-fleet remesh policy (pure decision, no side effects): given
    one service's ``ServiceFleet.snapshot()`` (rid-ordered dicts with
    ``state``/``inflight``/``ewma_ms``), decide what the supervisor should
    actuate to hold ``target`` ACTIVE replicas:

      dead replica      → ("release", rid)   drain() it — trivially quiesced,
                                             frees segment + child bookkeeping
      active < target   → ("join", n)        register n fresh replicas; each
                                             join epoch-bumps the service once
      active > target   → ("drain", rid)     drain the least-loaded actives,
                                             newest first on ties

    DRAINING/QUIESCED replicas count as neither active nor reclaimable —
    a prior sweep already decided them. Deterministic and order-stable
    (releases by rid, drains by (inflight, ewma, -rid)) so supervision
    sweeps are replayable in chaos tests, mirroring
    :func:`plan_gateway_recovery`."""
    actions = []
    for r in sorted((r for r in snapshot if r["state"] == "dead"),
                    key=lambda r: r["rid"]):
        actions.append(("release", r["rid"]))
    active = [r for r in snapshot if r["state"] == "active"]
    deficit = target - len(active)
    if deficit > 0:
        actions.append(("join", deficit))
    elif deficit < 0:
        surplus = sorted(active,
                         key=lambda r: (r["inflight"], r["ewma_ms"] or 0.0,
                                        -r["rid"]))[:-deficit]
        actions.extend(("drain", r["rid"]) for r in surplus)
    return actions


def plan_outlier_ejection(snapshot: list, *, factor: float = 4.0,
                          min_peers: int = 3, min_served: int = 32) -> list:
    """EWMA-latency outlier ejection policy (pure decision, no side
    effects), the service-mesh guard against the wedged-but-alive replica
    a liveness probe cannot catch: given one service's
    ``ServiceFleet.snapshot()``, eject ACTIVE replicas whose EWMA service
    time exceeds ``factor`` × the peer median.

      eject candidate → ("eject", rid)    the supervisor drains it and lets
                                          plan_fleet_scaling respawn capacity

    Guard rails, so ejection can't thrash a small or cold fleet:

    * needs ``min_peers`` ACTIVE replicas with an observed EWMA — with
      fewer there is no meaningful peer population to be an outlier OF;
    * a replica must have ``min_served`` completions before it can be
      ejected (its EWMA must be signal, not warmup noise);
    * the median is computed over the OTHER replicas (peer median), so one
      giant outlier cannot drag the threshold up past itself.

    Deterministic and order-stable (ejections by rid ascending) so
    supervision sweeps are replayable, mirroring the other planners."""
    observed = [r for r in snapshot
                if r["state"] == "active" and r["ewma_ms"] is not None]
    if len(observed) < min_peers:
        return []
    actions = []
    for r in sorted(observed, key=lambda r: r["rid"]):
        if r["served"] < min_served:
            continue
        peers = sorted(p["ewma_ms"] for p in observed
                       if p["rid"] != r["rid"])
        med = peers[len(peers) // 2] if len(peers) % 2 else \
            0.5 * (peers[len(peers) // 2 - 1] + peers[len(peers) // 2])
        if med > 0.0 and r["ewma_ms"] > factor * med:
            actions.append(("eject", r["rid"]))
    return actions
