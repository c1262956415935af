"""The paper's system end to end: MPKLink against the IPC alternatives.

Walks the MPKLink lifecycle of the paper's §V on the port:
  1. two microservices enroll with the CA (key pairs, proof of possession)
  2. the CA verifies certificates and grants a protected channel
     (protection domain + capability keys)
  3. word-count requests flow through the guarded shared region
     (per-chunk PKRU sync + per-message MAC, on the frame's device)
  4. the same workload runs over pipes / UDS / raw shm / simulated gRPC
     for the paper's comparison
  5. threat-model checks: forged seed, revoked key, tampered frame
  6. the on-device data plane: the hand-written guard kernel
     (``ops.guard_copy``) verifying a tensor's MAC on the card

    python -m repro_torch.examples.mpklink_demo [--device cuda]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import TRANSPORTS, framing
from repro_torch.core.domains import AccessViolation, READ
from repro_torch.core.transports import CapacityError, MPKLinkTransport
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler
from repro_torch.device import resolve
from repro_torch.examples._common import check, parser
from repro_torch.kernels import ops

WORDS = (100, 10_000, 200_000)
COMPARE_WORDS = 10_000


def lifecycle(device):
    print("=== MPKLink lifecycle (paper §V) ===")
    tr = MPKLinkTransport(wordcount_handler, device=device)
    print("CA enrolled services: svc-client, svc-server")
    print(f"channel domain: {tr.domain.name!r} (pkey {tr.domain.did}, "
          f"tag {tr.domain.tag:#010x})")
    print(f"session-derived MAC seed: {tr.seed:#010x}")
    tr.start()
    try:
        for n in WORDS:
            t0 = time.perf_counter()
            count = parse_count(tr.request(make_text(n, seed=n)))
            dt = time.perf_counter() - t0
            print(f"  {n:>8} words → count={count:<8} {dt*1e3:8.2f} ms  "
                  f"(cumulative key syncs: {tr.sync_count})")
            check(count == n, f"word count {count}, want {n}")
        # threat model: a revoked key fails at staging time
        tr.registry.revoke(tr.key_client)
        try:
            tr.registry.check(tr.key_client, READ)
        except AccessViolation as e:
            print(f"  revoked key rejected at staging time: {e}")
        else:
            check(False, "a revoked key passed the PKRU check")
    finally:
        tr.close()


def comparison(device):
    print("\n=== transport comparison (paper Fig. 3 region) ===")
    text = make_text(COMPARE_WORDS, seed=1)
    for name in ("pipe", "uds", "shm", "grpc_sim", "mpklink", "mpklink_opt"):
        tr = TRANSPORTS[name](wordcount_handler, device=device)
        tr.start()
        try:
            tr.request(text)                      # warm
            t0 = time.perf_counter()
            count = parse_count(tr.request(text))
            dt = time.perf_counter() - t0
            check(count == COMPARE_WORDS, f"{name}: count {count}")
            print(f"  {name:<12} {dt*1e6:9.0f} µs")
        except CapacityError as e:
            check(name == "shm", f"{name} refused the payload: {e}")
            print(f"  {name:<12} FAILED ({e})")
        finally:
            tr.close()


def threats(device):
    print("\n=== threat model: forged seed, tampered frame ===")
    seed = 0x5EED1234
    arr = np.arange(300, dtype=np.int32)
    forged = framing.build_frame(arr, seed=seed ^ 0xDEAD, seq=0, device=device)
    try:
        framing.verify_view(forged, seed=seed, expect_seq=0)
    except framing.FrameError as e:
        print(f"  forged seed rejected: {e}")
    else:
        check(False, "a frame under a forged seed verified")
    frame = framing.build_frame(arr, seed=seed, seq=0, device=device)
    got = framing.verify_view(frame, seed=seed, expect_seq=0)
    check(np.array_equal(got.cpu().numpy(), arr), "the genuine frame's payload")
    frame.view(torch.int32)[1, 5] ^= 1                  # one payload bit
    try:
        framing.verify_view(frame, seed=seed, expect_seq=0)
    except framing.FrameError as e:
        print(f"  tampered frame rejected: {e}")
    else:
        check(False, "a tampered frame verified")


def data_plane(device):
    print("\n=== on-device data plane: the mpk_guard kernel ===")
    payload = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2**32, (256, 128), dtype=np.uint64).astype(np.uint32)).to(device)
    tag = 0xBEEF
    before = ops.LAUNCHES.snapshot()
    m = int(ops.mac_batch(payload[None], tag).cpu().tolist()[0])
    out, macv, ok = ops.guard_copy(payload, tag, m)
    print(f"  authenticated copy: mac={int(macv.cpu()[0]):#010x} "
          f"ok={int(ok.cpu()[0])}")
    tampered = payload.clone()
    tampered.view(torch.int32)[100, 7] += 1
    _, _, ok2 = ops.guard_copy(tampered, tag, m)
    print(f"  tampered payload:   ok={int(ok2.cpu()[0])} (rejected)")
    check(int(ok.cpu()[0]) == 1 and int(ok2.cpu()[0]) == 0,
          "guard_copy's verdicts")
    check(torch.equal(out.view(torch.int32), payload.view(torch.int32)),
          "guard_copy's protected copy")
    after = ops.LAUNCHES.snapshot()
    launched = {k: after[k] - before[k] for k in ("mac_batch", "guard_copy")}
    if payload.is_cuda:
        check(launched == {"mac_batch": 1, "guard_copy": 2},
              f"guard kernel launches {launched}")
    print(f"  kernel launches: {launched}")


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    device = resolve(args.device)
    lifecycle(device)
    comparison(device)
    threats(device)
    data_plane(device)
    print("\nmpklink_demo OK")


if __name__ == "__main__":
    main()
