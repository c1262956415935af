"""Recovery and scaling policies for the service plane (the port of the
pure planners of ``repro.runtime.elastic``).

Each planner is a pure decision over a snapshot (no side effects), so a
supervisor's sweeps replay exactly: :func:`plan_gateway_recovery` over a
gateway's health snapshot (``fault.GatewaySupervisor``),
:func:`plan_fleet_scaling` and :func:`plan_outlier_ejection` over a
replica fleet's snapshot (``core.gateway.FleetSupervisor``).

Not ported yet (the multi-device fabric, ROADMAP.md queue 1, item 5): the
reference's ``plan_remesh``, ``remesh`` and ``elastic_restore``, which
re-mesh a training job after chip failures.
"""
from __future__ import annotations


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
