"""Chaos walkthrough: a self-healing gateway under a seeded fault storm.

Demonstrates the port's deterministic fault-injection fabric end to end:
  1. a gateway with a restartable service runs a seeded FaultPlan mixing
     all eight fault kinds — every injected security fault is rejected
     with its exact typed error, liveness faults stay bounded
  2. the SAME seed is replayed: an outcome-for-outcome identical run
  3. a healing client (bounded retries + idempotency tokens) rides out
     crashes and dropped responses with zero wrong answers and zero
     double executions (dropped responses are answered from the dedup
     window)
  4. a factory-less flaky service trips the circuit breaker: requests are
     shed with typed ServiceUnavailable instead of hanging, then a probe
     closes the circuit once the service recovers

    python -m repro_torch.examples.chaos_demo [--device cuda]
"""
from __future__ import annotations

import time

from repro_torch.core import ServiceGateway
from repro_torch.core.faultwire import ALL_KINDS, FaultFabric, FaultPlan, FaultyClient
from repro_torch.core.transports import ServiceUnavailable, TransportError
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler
from repro_torch.device import resolve
from repro_torch.examples._common import check, parser

TIMEOUT = 0.3
SEED = 42
N_REQUESTS = 48


def _wordcount_factory():
    return wordcount_handler


def run_storm(device, seed: int, retries: int = 0):
    gw = ServiceGateway("mpklink_opt", transport_kwargs={"timeout": TIMEOUT},
                        device=device)
    gw.register_service("wordcount", wordcount_handler, factory=_wordcount_factory)
    gw.start()
    plan = FaultPlan(seed=seed, n_requests=N_REQUESTS, rate=0.25)
    fab = FaultFabric(plan).attach(gw)
    fc = FaultyClient(gw.connect("storm-rider", retries=retries), fab, "wordcount")
    try:
        for i in range(plan.n_requests):
            n = 6 + i % 9
            out = fc.step(make_text(n, seed=i))
            if out.ok:
                check(parse_count(out.value) == n,
                      f"wrong answer at request {i}: {plan.describe()}")
            else:
                check(out.kind is not None,
                      f"collateral error at request {i}: {out.value!r}")
    finally:
        gw.close()
    sig = [(o.index, o.status, o.kind, type(o.value).__name__) for o in fc.outcomes]
    return plan, sig, fc.counts(), dict(gw.stats)


def warm_up(device):
    """One call through a gateway on ``device`` off the storm's clock, so
    the storm's first requests do not pay for loading the guard kernels."""
    gw = ServiceGateway("mpklink_opt", device=device)
    gw.register_service("wordcount", wordcount_handler)
    gw.start()
    try:
        gw.connect("warm").call("wordcount", make_text(8, seed=0))
    finally:
        gw.close()


def breaker(device):
    print("\n=== 4. circuit breaker on a factory-less flaky service ===")
    state = {"n": 0}

    def flaky(req):
        state["n"] += 1
        if state["n"] <= 3:
            raise ValueError("flaky dependency")
        return wordcount_handler(req)

    gw = ServiceGateway("uds", device=device)
    gw.register_service("flaky", flaky, failure_threshold=3, probe_after=2)
    gw.start()
    seen = []
    try:
        c = gw.connect("ops")
        for i in range(8):
            try:
                n = parse_count(c.call("flaky", make_text(5, seed=i)))
                seen.append("ok")
                print(f"    call {i}: ok ({n} words) "
                      f"[health: {gw.health()['flaky']['state']}]")
            except ServiceUnavailable as e:
                seen.append("shed")
                print(f"    call {i}: SHED  ({e})")
            except TransportError as e:     # the handler's error, typed
                seen.append("fail")
                print(f"    call {i}: fail  ({type(e).__name__})")
        health = gw.health()["flaky"]
        print(f"  final health: {health}")
    finally:
        gw.close()
    check(seen[:3] == ["fail"] * 3 and "shed" in seen and seen[-1] == "ok",
          f"breaker outcomes {seen}")
    check(health["state"] == "closed", f"the circuit did not close: {health}")


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    device = resolve(args.device)
    warm_up(device)
    print("=== 1. seeded fault storm (strict client) ===")
    t0 = time.perf_counter()
    plan, sig, counts, stats = run_storm(device, SEED)
    dt = time.perf_counter() - t0
    print(f"  {plan.describe()}")
    for idx, status, kind, vtype in sig:
        if kind is not None:
            print(f"    req {idx:>2}: {kind:<15} -> {status:<9} {vtype}")
    print(f"  outcomes: {counts} in {dt*1e3:.0f} ms "
          f"(every fault typed + bounded, zero collateral errors)")
    print(f"  gateway stats: {stats}")
    check({e.kind for e in plan.schedule()} == set(ALL_KINDS),
          "the storm lacks a fault kind")

    print("\n=== 2. replay: identical seed, identical run ===")
    _, sig2, _, _ = run_storm(device, SEED)
    print(f"  outcome sequences identical: {sig == sig2}")
    check(sig == sig2, "the replay's outcomes differ")

    print("\n=== 3. healing client (retries=3 + idempotency tokens) ===")
    plan, sig, counts, stats = run_storm(device, SEED, retries=3)
    recovered = [s for s in sig if s[1] == "recovered"]
    print(f"  liveness faults transparently healed: {len(recovered)} "
          f"(crash/drop/delay), deduped replies: {stats['deduped']}, "
          f"restarts: {stats['restarts']}")
    print(f"  outcomes: {counts}")
    check(recovered and counts.get("error", 0) == 0,
          f"the healing client's outcomes {counts}")

    breaker(device)
    print("\nchaos_demo OK")


if __name__ == "__main__":
    main()
