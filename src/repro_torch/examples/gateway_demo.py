"""The MPKLink service gateway end to end: many clients, many services, one
protected transport.

Walks the gateway lifecycle on top of the paper's §V machinery, on the
port:
  1. three named services register (CA enrollment + one protection domain
     each): wordcount, reverse, and a restricted "billing" service
  2. concurrent clients enroll, open per-service channels (CA-verified key
     issue on the service's domain) and call the services in parallel
  3. isolation: a client without a billing key is refused by the CA, and a
     forged frame under the wrong channel seed is rejected by the guard
  4. revocation: one key revoked → domain epoch bump → stale keys fail the
     PKRU check until their holders re-open

    python -m repro_torch.examples.gateway_demo [--device cuda]
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.core import AccessViolation, ServiceGateway, framing
from repro_torch.core.gateway import _ERR, _ROUTE_BYTES, GW_MAGIC
from repro_torch.core.transports import _raise_remote
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler
from repro_torch.device import resolve
from repro_torch.examples._common import check, parser

N_CLIENTS, REPS = 8, 5


def reverse(req):
    return req.flip(0)


def billing(req):
    return req


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def concurrent_clients(gw):
    errors = []

    def worker(i):
        try:
            c = gw.connect(f"svc-client-{i}")
            for j in range(REPS):
                n = 100 * (i + 1) + j
                got = parse_count(c.call("wordcount", make_text(n, seed=j)))
                check(got == n, f"client {i}: count {got}, want {n}")
                arr = np.arange(i, i + 16, dtype=np.int32)
                check(np.array_equal(_host(c.call("reverse", arr)), arr[::-1]),
                      f"client {i}: reverse")
            c.close()
        except Exception as e:                # noqa: BLE001 — gathered below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    total = N_CLIENTS * REPS * 2
    print(f"  {N_CLIENTS} concurrent clients × {REPS} calls × 2 services: "
          f"{total} requests in {dt*1e3:.0f} ms ({total/dt:.0f} req/s), "
          f"errors={errors}")
    check(not errors, f"client errors: {errors}")
    print(f"  gateway stats: {gw.stats}")


def isolation(gw):
    print("\n=== isolation ===")
    outsider = gw.connect("outsider")
    try:
        outsider.call("billing", np.arange(4, dtype=np.int32))
    except AccessViolation as e:
        print(f"  CA refused foreign client: {e}")
    else:
        check(False, "an unauthorized client was served")
    acct = gw.connect("accounting")
    check(list(_host(acct.call("billing", np.arange(4, dtype=np.int32))))
          == [0, 1, 2, 3], "the allow-listed client's answer")
    print("  allow-listed client served")
    # a frame sealed under the wrong channel seed, sent on the right route
    chan = acct._channels["billing"]
    bad = framing.build_frame(np.arange(4, dtype=np.int32), seed=chan.seed ^ 0xDEAD,
                              seq=chan.seq, device=gw.device)
    env = torch.cat([torch.from_numpy(np.array(
        [GW_MAGIC, chan.sid, acct.cid, 0], "<u4").view(np.uint8)).to(gw.device),
        bad.reshape(-1).view(torch.uint8)])
    resp = acct._session.request(env).cpu().numpy().view(np.uint8)
    route = resp[:_ROUTE_BYTES].view("<u4")
    check(int(route[1]) == _ERR, "the gateway answered a forged frame")
    try:
        _raise_remote(resp[_ROUTE_BYTES:_ROUTE_BYTES + int(route[3])].tobytes())
    except framing.FrameError as e:
        print(f"  forged frame rejected by the guard: {e}")
    else:
        check(False, "a forged frame passed the guard")


def revocation(gw):
    print("\n=== revocation (epoch bump) ===")
    alice, bob = gw.connect("alice"), gw.connect("bob")
    alice.call("wordcount", make_text(10, seed=0))
    bob.call("wordcount", make_text(10, seed=0))
    old_key = bob._channels["wordcount"].client_key
    gw.revoke(alice, "wordcount")
    # bob's cached key is now stale (epoch bumped); his next call re-keys
    # through the CA transparently — a banned client could not
    check(parse_count(bob.call("wordcount", make_text(10, seed=0))) == 10,
          "bob's call after the epoch bump")
    check(bob._channels["wordcount"].client_key is not old_key,
          "bob was not re-keyed")
    print("  epoch bump staled bob's key; CA re-keyed him transparently")
    gw.ca.revoke_service("alice")
    try:
        alice.call("wordcount", make_text(10, seed=0))
    except AccessViolation as e:
        print(f"  banned client refused re-key: {e}")
    else:
        check(False, "a banned client was served")


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    print("=== gateway: 3 services on one mpklink_opt transport ===")
    gw = ServiceGateway("mpklink_opt", device=resolve(args.device))
    gw.register_service("wordcount", wordcount_handler)
    gw.register_service("reverse", reverse)
    gw.register_service("billing", billing, allow={"accounting"})
    gw.start()
    try:
        concurrent_clients(gw)
        isolation(gw)
        revocation(gw)
    finally:
        gw.close()
    print("\ngateway_demo OK")


if __name__ == "__main__":
    main()
