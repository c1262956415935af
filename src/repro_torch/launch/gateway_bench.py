"""The gateway's benchmark on the port (the twin of
``benchmarks/gateway_bench.py``): N clients x named services x transports
through the port's ``ServiceGateway``.

    python -m repro_torch.launch.gateway_bench [--device cuda] [--quick]
        [--no-infer] [--no-batch] [--no-payload] [--no-scatter]
        [--no-fanin] [--out f.json]

The reference's five sweeps, with its flags:

  per-client  clients in {1, 4, 16, 64} against ``wordcount`` (the paper's
              workload) and ``infer`` (the port's ``EngineService`` over
              reduced llama3.2-1b, continuous batching) on one transport
              (:func:`run_cell`);
  batch       one client keeping k in {1, 4, 16} messages in flight with
              ``call_batch`` against the lockstep baseline
              (:func:`run_batch_cell`);
  payload     one client pushing 64 KiB - 1 MiB payloads, lockstep and 4
              in flight, each cell in both planes (:func:`run_payload_cell`
              sets ``framing.ZERO_COPY``): the legacy copy plane (pad and
              header concatenations, the two-launch MACs) against the
              in-place one, reported as ``zero_copy_speedup``;
  scatter     one client fanning one request to each of 4 services as
              sequential ``call()``s against one ``call_many`` envelope on
              ``workers`` in {0, 4} shards (:func:`run_scatter_cell`);
  fan-in      64-256 inline callers with the coalescing mux off and on
              (:func:`run_fanin_cell`).

``--device`` (default ``cuda``) is where the transports keep their regions
and the guard kernels run; on the CPU the kernels' plain versions run.
Every cell prints one JSON line, with the ``os.cpu_count()`` of the host
and the device's name: these are host-bound timings, and the reference's
gates (ratios measured on another host) are reported, and enforced only on
full runs as the reference does; its zero-copy gate
(``zero_copy_gate_mpklink_opt_1p5x``) is reported and never enforced.

:func:`single_launches`, :func:`batch_launches`, :func:`scatter_launches`
and :func:`envelope_syncs` give the guard-kernel launches and key syncs of
one envelope of each kind from the code's structure, in either copy plane
(``zero_copy=False``: the legacy plane's) (as
``launch.ipc_wordcount.lockstep_launches`` / ``lockstep_syncs`` do for a
bare transport); the card run holds the counted launches to them.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import ServiceGateway, framing
from repro_torch.core.gateway import _ROUTE_BYTES
from repro_torch.core.wordcount import make_text, wordcount_handler
from repro_torch.launch.ipc_wordcount import (_add, _mac_batch_launches,
                                              _seal_launches, lockstep_syncs)

CLIENTS = [1, 4, 16, 64]
TRANSPORTS_ORDER = ["pipe", "uds", "shm", "grpc_sim", "mpklink", "mpklink_opt"]
WORDS = 2_000                         # wordcount payload (about 14 KB)
PROMPT_LEN = 4
MAX_NEW = 16                          # decode-dominated requests
PAYLOAD_SIZES = [64 * 1024, 256 * 1024, 1024 * 1024]
PAYLOAD_IN_FLIGHT = 4
SCATTER_SERVICES = 4
SCATTER_DELAY = 0.003                 # simulated downstream I/O per handler
BATCH_IN_FLIGHT = [1, 4, 16]
FANIN_CLIENTS = [64, 256]
FANIN_WORDS = 200
FANIN_MAX_BATCH = 64
FANIN_MAX_WAIT_US = 500.0
ROW_BYTES = framing.LANES * 4


# ---------------------------------------------------------------------------
# what one envelope costs, from the code
# ---------------------------------------------------------------------------

def _frame_bytes(nbytes: int) -> int:
    return framing.frame_rows(nbytes) * ROW_BYTES


def single_bytes(req: int, resp: int) -> Tuple[int, int]:
    """(request, response) envelope bytes of one ``call``: route words and
    one frame each."""
    return _ROUTE_BYTES + _frame_bytes(req), _ROUTE_BYTES + _frame_bytes(resp)


def batch_bytes(req: Sequence[int], resp: Sequence[int]) -> Tuple[int, int]:
    """(request, response) envelope bytes of one ``call_batch`` whose items
    all succeed: N frames; N item routes and frames back."""
    return (_ROUTE_BYTES + sum(_frame_bytes(n) for n in req),
            _ROUTE_BYTES + sum(_ROUTE_BYTES + _frame_bytes(n) for n in resp))


def scatter_bytes(req: Sequence[int], resp: Sequence[int]) -> Tuple[int, int]:
    """(request, response) envelope bytes of one ``call_many`` whose items
    all succeed: an item route and a frame per item, both ways."""
    return (_ROUTE_BYTES + sum(_ROUTE_BYTES + _frame_bytes(n) for n in req),
            _ROUTE_BYTES + sum(_ROUTE_BYTES + _frame_bytes(n) for n in resp))


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


# the MAC kernels of the legacy copy plane (framing.ZERO_COPY = False)
LEGACY_KERNELS = {"mac_update": "mac_update_two_pass",
                  "mac_batch": "mac_batch_two_pass"}


def _plane(counts: Dict[str, int], zero_copy: bool) -> Dict[str, int]:
    """``counts`` in the legacy copy plane when not ``zero_copy``: every
    ``mac_update`` and ``mac_batch`` run by the earlier two-launch kernels
    (``guard_copy`` and the streaming MAC's init and fold unchanged)."""
    if zero_copy:
        return counts
    return {LEGACY_KERNELS.get(k, k): v for k, v in counts.items()}


def single_launches(req: int, resp: int, device,
                    zero_copy: bool = True) -> Dict[str, int]:
    """Guard-kernel launches of one ``call`` over an mpklink transport on
    the card: the client seals the frame (``fast_mac``) and the transport
    the envelope; the gateway's transport verifies the envelope and the
    gateway the frame (one ``guard_copy`` each), seals the response frame
    and its transport the response envelope; the client's transport and
    the client verify them. None on the CPU. ``zero_copy=False``: the
    legacy copy plane's (the same seals, by the two-launch MAC kernels)."""
    if not _on_card(device):
        return {}
    env_req, env_resp = single_bytes(req, resp)
    return _plane(_add(_seal_launches(req), _seal_launches(env_req),
                       _seal_launches(resp), _seal_launches(env_resp),
                       {"guard_copy": 4}), zero_copy)


def batch_launches(req: Sequence[int], resp: Sequence[int],
                   device, zero_copy: bool = True) -> Dict[str, int]:
    """Guard-kernel launches of one ``call_batch``: the N frames are sealed
    (client), verified (gateway), the responses sealed (gateway) and
    verified (client) with one ``mac_batch`` launch per row count each;
    the two envelopes are sealed and verified by the transport (in the
    legacy copy plane, with ``zero_copy=False``, by the two-launch MAC
    kernels)."""
    if not _on_card(device):
        return {}
    env_req, env_resp = batch_bytes(req, resp)
    return _plane(_add(_seal_launches(env_req), _seal_launches(env_resp),
                       {"guard_copy": 2,
                        "mac_batch": 2 * _mac_batch_launches(req)
                        + 2 * _mac_batch_launches(resp)}), zero_copy)


def scatter_launches(items: Sequence[Tuple[str, int, int]],
                     device, zero_copy: bool = True) -> Dict[str, int]:
    """Guard-kernel launches of one ``call_many`` of (service, request
    bytes, response bytes) items: the client seals each service's frames
    and verifies its responses with ``mac_batch`` launches (one per row
    count of the group); the gateway verifies each item with its own
    ``guard_copy`` (the single-call pipeline) and seals each group's
    responses with ``mac_batch``; the transport seals and verifies the two
    envelopes. In the legacy copy plane (``zero_copy=False``) the client
    builds each item's frame apart (one streaming MAC each, as the
    reference's legacy ``call_many`` does), and every MAC runs the
    two-launch kernels."""
    if not _on_card(device):
        return {}
    groups: Dict[str, Tuple[List[int], List[int]]] = {}
    for service, req, resp in items:
        g = groups.setdefault(service, ([], []))
        g[0].append(req)
        g[1].append(resp)
    env_req, env_resp = scatter_bytes([r for _, r, _ in items],
                                      [r for _, _, r in items])
    mb = sum(2 * _mac_batch_launches(r) for _, r in groups.values())
    if zero_copy:
        client = {"mac_batch": sum(_mac_batch_launches(q) for q, _ in groups.values())}
    else:
        client = _add(*(_seal_launches(req) for _, req, _ in items))
    return _plane(_add(_seal_launches(env_req), _seal_launches(env_resp), client,
                       {"guard_copy": 2 + len(items), "mac_batch": mb}), zero_copy)


def envelope_syncs(tr, env_req: int) -> int:
    """Key syncs of one envelope of ``env_req`` bytes: a lockstep exchange
    of the gateway's transport."""
    return lockstep_syncs(tr, env_req)


# ---------------------------------------------------------------------------
# services
# ---------------------------------------------------------------------------

def build_engine_service(max_batch: int = 32, max_seq: int = 64,
                         device="cuda"):
    """The port's ``EngineService`` over reduced llama3.2-1b (random
    weights from a seeded generator), warmed up off the clock."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import init_params
    from repro_torch.runtime import EngineService, ServingEngine, encode_prompt

    cfg = get_reduced("llama3.2-1b")
    dev = torch.device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    engine = ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                           device=dev)
    svc = EngineService(engine).start()
    svc.handler(encode_prompt([1, 2, 3], max_new=2))
    return svc


def digest_handler(req: torch.Tensor) -> torch.Tensor:
    """A cheap fixed-cost handler for large payloads: the byte sum (int64,
    on the request's device), so a cell measures the seal/verify/copy
    path and the response stays one frame row."""
    return req.reshape(-1).view(torch.uint8).sum(dtype=torch.int64).reshape(1)


def make_micro_handler(i: int, delay: float = SCATTER_DELAY):
    """One 'microservice': a small sleep (downstream I/O the sharded
    executor can overlap) plus a digest."""
    def handler(req: torch.Tensor) -> torch.Tensor:
        time.sleep(delay)
        return digest_handler(req) + i
    return handler


def _pcts(lats: List[float]) -> Tuple[Optional[float], Optional[float]]:
    if not lats:
        return None, None
    a = np.asarray(sorted(lats))
    return (round(float(np.percentile(a, 50)) * 1e3, 3),
            round(float(np.percentile(a, 99)) * 1e3, 3))


def _host() -> dict:
    return {"cpu_count": os.cpu_count()}


# ---------------------------------------------------------------------------
# the five sweeps
# ---------------------------------------------------------------------------

def run_cell(gw: ServiceGateway, service: str, n_clients: int, reps: int,
             make_payload) -> Dict:
    """n_clients threads, each with its own gateway client/session, all
    calling ``service`` for ``reps`` requests; wall-clocked together."""
    latencies: List[List[float]] = [[] for _ in range(n_clients)]
    errors: List[str] = []
    clients = [gw.connect(f"bench-{service}-{n_clients}-{i}")
               for i in range(n_clients)]
    for c in clients:                       # channel setup off the clock
        c.open(service)
    barrier = threading.Barrier(n_clients + 1)

    def worker(i):
        c = clients[i]
        try:
            barrier.wait()
            for j in range(reps):
                t0 = time.perf_counter()
                c.call(service, make_payload(i, j))
                latencies[i].append(time.perf_counter() - t0)
        except Exception as e:              # reported in the cell
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    stats0 = dict(gw.stats)
    sync0 = getattr(gw.transport, "sync_count", 0)
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    stats1 = dict(gw.stats)
    sync1 = getattr(gw.transport, "sync_count", 0)
    client_macs = sum(c.macs_verified for c in clients)
    for c in clients:
        c.close()
    lats = sum(latencies, [])
    total = len(lats)
    p50, p99 = _pcts(lats)
    server_macs = stats1["macs_verified"] - stats0["macs_verified"]
    return {"service": service, "clients": n_clients, "requests": total,
            "errors": errors, "seconds": round(wall, 4),
            "throughput_rps": round(total / wall, 2) if wall > 0 else None,
            "p50_ms": p50, "p99_ms": p99, "key_syncs": sync1 - sync0,
            "macs_verified_server": server_macs,
            "macs_verified_clients": client_macs,
            "all_macs_verified": (not errors and server_macs == total
                                  and client_macs == total),
            "rejected": stats1["rejected"] - stats0["rejected"]}


def run_batch_cell(gw: ServiceGateway, service: str, in_flight: int,
                   total_msgs: int, make_payload, mode: str) -> Dict:
    """One client pushing ``total_msgs`` messages at ``in_flight`` per round
    trip: ``mode='lockstep'`` one call() at a time, ``mode='batched'`` as
    ``call_batch`` envelopes of ``in_flight`` messages."""
    client = gw.connect(f"bench-batch-{service}-{mode}-{in_flight}")
    client.open(service)
    stats0 = dict(gw.stats)
    sync0 = getattr(gw.transport, "sync_count", 0)
    lat: List[float] = []
    errors: List[str] = []
    sent = 0
    t0 = time.perf_counter()
    while sent < total_msgs:
        k = min(in_flight, total_msgs - sent)
        payloads = [make_payload(sent + j) for j in range(k)]
        tb = time.perf_counter()
        try:
            if mode == "lockstep":
                for p in payloads:
                    client.call(service, p)
            else:
                client.call_batch(service, payloads)
        except Exception as e:              # reported in the cell
            errors.append(repr(e))
            break
        lat.append(time.perf_counter() - tb)
        sent += k
    wall = time.perf_counter() - t0
    stats1 = dict(gw.stats)
    sync1 = getattr(gw.transport, "sync_count", 0)
    server_macs = stats1["macs_verified"] - stats0["macs_verified"]
    client_macs = client.macs_verified
    client.close()
    p50, p99 = _pcts(lat)
    return {"service": service, "mode": mode, "in_flight": in_flight,
            "messages": sent, "errors": errors, "seconds": round(wall, 4),
            "throughput_rps": round(sent / wall, 2) if wall > 0 else None,
            "p50_batch_ms": p50, "p99_batch_ms": p99,
            "key_syncs": sync1 - sync0,
            "macs_verified_server": server_macs,
            "macs_verified_clients": client_macs,
            "all_macs_verified": (not errors and server_macs == sent
                                  and client_macs == sent),
            "rejected": stats1["rejected"] - stats0["rejected"]}


def run_payload_cell(gw: ServiceGateway, nbytes: int, reps: int,
                     zero_copy: bool = True, in_flight: int = 1) -> Dict:
    """One client, one channel, a fixed ``nbytes`` payload: lockstep
    ``call()`` (``in_flight=1``) or ``call_batch`` of ``in_flight``, with
    the framing layer in the in-place plane (``zero_copy``) or the legacy
    copy plane (``framing.ZERO_COPY`` set for the cell and restored after
    it); the framing counters give the bytes copied and the concatenations
    a request."""
    rng = np.random.default_rng(nbytes)
    payload = rng.integers(0, 256, size=nbytes, dtype=np.int64).astype(np.uint8)
    client = gw.connect(f"bench-payload-{nbytes}-{zero_copy}-{in_flight}")
    client.open("digest")
    prev = framing.ZERO_COPY
    framing.ZERO_COPY = zero_copy
    try:
        def drive():
            if in_flight == 1:
                client.call("digest", payload)
            else:
                client.call_batch("digest", [payload] * in_flight)

        for _ in range(3):                  # warm-up / channel setup
            drive()
        st0 = framing.STATS.snapshot()
        sync0 = getattr(gw.transport, "sync_count", 0)
        lat: List[float] = []
        t0 = time.perf_counter()
        for _ in range(reps):
            tb = time.perf_counter()
            drive()
            lat.append(time.perf_counter() - tb)
        wall = time.perf_counter() - t0
        st1 = framing.STATS.snapshot()
        sync1 = getattr(gw.transport, "sync_count", 0)
    finally:
        framing.ZERO_COPY = prev
    macs = client.macs_verified
    client.close()
    total = reps * in_flight
    p50, p99 = _pcts(lat)
    return {"service": "digest", "payload_bytes": nbytes,
            "mode": "zero_copy" if zero_copy else "legacy",
            "in_flight": in_flight, "requests": total, "seconds": round(wall, 4),
            "throughput_rps": round(total / wall, 2) if wall > 0 else None,
            "mib_per_s": round(total * nbytes / wall / 2**20, 2)
            if wall > 0 else None,
            "p50_ms": p50, "p99_ms": p99, "key_syncs": sync1 - sync0,
            "bytes_copied_per_request":
                round((st1["bytes_copied"] - st0["bytes_copied"]) / total),
            "concat_calls_per_request":
                round((st1["concat_calls"] - st0["concat_calls"]) / total, 2),
            "macs_verified_clients": macs}


def run_scatter_cell(transport: str, workers: int, n_services: int,
                     rounds: int, mode: str, device="cuda") -> Dict:
    """One client fanning one request per service per round:
    ``sequential`` issues n_services lockstep call()s, ``scatter`` ONE
    ``call_many`` envelope executed across the gateway's shards."""
    gw = ServiceGateway(transport, max_keys=256, workers=workers, device=device)
    for i in range(n_services):
        gw.register_service(f"svc{i}", make_micro_handler(i))
    gw.start()
    try:
        client = gw.connect(f"bench-scatter-{mode}-{workers}")
        items = [(f"svc{i}", make_text(200, seed=i)) for i in range(n_services)]
        for service, p in items:            # warm-up + channel setup
            client.call(service, p)
        lat: List[float] = []
        t0 = time.perf_counter()
        for _ in range(rounds):
            tb = time.perf_counter()
            if mode == "sequential":
                for service, p in items:
                    client.call(service, p)
            else:
                client.call_many(items)
            lat.append(time.perf_counter() - tb)
        wall = time.perf_counter() - t0
        total = rounds * n_services
        p50, p99 = _pcts(lat)
        stats = dict(gw.stats)
        shards = gw.shard_stats()
        client.close()
        return {"mode": mode, "workers": workers, "services": n_services,
                "rounds": rounds, "requests": total, "seconds": round(wall, 4),
                "throughput_rps": round(total / wall, 2) if wall > 0 else None,
                "p50_round_ms": p50, "p99_round_ms": p99,
                "scatter_envelopes": stats["scatter_envelopes"],
                "rejected": stats["rejected"], "shards": shards,
                "transport": transport}
    finally:
        gw.close()


def run_fanin_cell(transport: str, n_clients: int, reps: int,
                   coalesce: bool, device="cuda") -> Dict:
    """n_clients caller threads, each its own CA-enrolled client, all
    issuing inline call()s; ``coalesce`` flips the gateway's auto-batching
    mux (callers are the same either way)."""
    gw = ServiceGateway(transport, max_keys=2048, device=device)
    gw.register_service("wordcount", wordcount_handler)
    gw.start()
    mux = (gw.enable_coalescing(max_batch=FANIN_MAX_BATCH,
                                max_wait_us=FANIN_MAX_WAIT_US)
           if coalesce else None)
    clients = [gw.connect(f"fanin-{n_clients}-{int(coalesce)}-{i}")
               for i in range(n_clients)]
    for c in clients:                       # channel setup off the clock;
        c.open("wordcount")                 # inline cells also open their
        if not coalesce:                    # wire sessions first
            c._session
    latencies: List[List[float]] = [[] for _ in range(n_clients)]
    errors: List[str] = []
    barrier = threading.Barrier(n_clients + 1)

    def worker(i):
        c = clients[i]
        try:
            barrier.wait()
            for j in range(reps):
                t0 = time.perf_counter()
                c.call("wordcount", make_text(FANIN_WORDS, seed=i * 131 + j))
                latencies[i].append(time.perf_counter() - t0)
        except Exception as e:              # reported in the cell
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    stats0 = dict(gw.stats)
    st0 = framing.STATS.snapshot()
    sync0 = getattr(gw.transport, "sync_count", 0)
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    stats1 = dict(gw.stats)
    st1 = framing.STATS.snapshot()
    sync1 = getattr(gw.transport, "sync_count", 0)
    client_macs = sum(c.macs_verified for c in clients)
    if mux is not None:
        client_macs += mux._carrier.macs_verified
    mux_stats = dict(mux.stats) if mux is not None else None
    for c in clients:
        c.close()
    gw.close()
    lats = sum(latencies, [])
    total = len(lats)
    p50, p99 = _pcts(lats)
    server_macs = stats1["macs_verified"] - stats0["macs_verified"]

    def per(x):
        return round(x / total, 3) if total else None

    return {"service": "wordcount", "mode": "coalesced" if coalesce else "inline",
            "clients": n_clients, "requests": total, "errors": errors,
            "seconds": round(wall, 4),
            "throughput_rps": round(total / wall, 2) if wall > 0 else None,
            "p50_ms": p50, "p99_ms": p99, "key_syncs": sync1 - sync0,
            "syncs_per_request": per(sync1 - sync0),
            "wakeups_per_request": per(st1["wakeups"] - st0["wakeups"]),
            "doorbell_parks_per_request":
                per(st1["doorbell_parks"] - st0["doorbell_parks"]),
            "macs_verified_server": server_macs,
            "macs_verified_clients": client_macs,
            "all_macs_verified": (not errors and server_macs == total
                                  and client_macs == total),
            "rejected": stats1["rejected"] - stats0["rejected"],
            "coalescer": mux_stats, "transport": transport}


def _emit(sweep: str, cell: dict, device) -> dict:
    rec = {"sweep": sweep, "device": str(torch.device(device)), **_host(), **cell}
    print(json.dumps(rec), flush=True)
    return cell


def sweep(transports, clients, reps_wordcount, reps_infer, engine_service,
          device="cuda") -> List[Dict]:
    results = []
    for name in transports:
        gw = ServiceGateway(name, max_keys=256, device=device)
        gw.register_service("wordcount", wordcount_handler)
        if engine_service is not None:
            gw.register_service("infer", engine_service.handler)
        gw.start()
        try:
            for n in clients:
                cell = run_cell(gw, "wordcount", n, reps_wordcount,
                                lambda i, j: make_text(WORDS, seed=i * 131 + j))
                cell["transport"] = name
                results.append(_emit("clients", cell, device))
                if engine_service is not None:
                    from repro_torch.runtime import encode_prompt
                    cell = run_cell(gw, "infer", n, reps_infer,
                                    lambda i, j: encode_prompt(
                                        [1 + (i + j) % 29, 2, 3, 4][:PROMPT_LEN],
                                        max_new=MAX_NEW))
                    cell["transport"] = name
                    results.append(_emit("clients", cell, device))
        finally:
            gw.close()
    return results


def sweep_batch(transports, total_msgs, infer_msgs, engine_service,
                device="cuda") -> List[Dict]:
    results = []
    for name in transports:
        gw = ServiceGateway(name, max_keys=256, device=device)
        gw.register_service("wordcount", wordcount_handler)
        if engine_service is not None:
            gw.register_service("infer", engine_service.handler,
                                batch_handler=engine_service.handler_batch)
        gw.start()
        try:
            for mode, k in [("lockstep", 1)] + [("batched", k)
                                                for k in BATCH_IN_FLIGHT]:
                cell = run_batch_cell(gw, "wordcount", k, total_msgs,
                                      lambda j: make_text(WORDS, seed=j), mode)
                cell["transport"] = name
                results.append(_emit("batch", cell, device))
                if engine_service is not None:
                    from repro_torch.runtime import encode_prompt
                    cell = run_batch_cell(
                        gw, "infer", k, infer_msgs,
                        lambda j: encode_prompt([1 + j % 29, 2, 3, 4][:PROMPT_LEN],
                                                max_new=MAX_NEW), mode)
                    cell["transport"] = name
                    results.append(_emit("batch", cell, device))
        finally:
            gw.close()
    return results


def sweep_payload(transports, sizes, reps, device="cuda") -> List[Dict]:
    """Every (transport, size, in-flight) cell in the legacy copy plane and
    the in-place one, as the reference's sweep runs them: the A/B is the
    whole plane (copies and MAC kernels), with bit-identical frames."""
    results = []
    for name in transports:
        for zero_copy in (False, True):
            gw = ServiceGateway(name, max_keys=256, device=device)
            gw.register_service("digest", digest_handler)
            gw.start()
            try:
                for nbytes in sizes:
                    for in_flight in (1, PAYLOAD_IN_FLIGHT):
                        cell = run_payload_cell(gw, nbytes, reps, zero_copy,
                                                in_flight)
                        cell["transport"] = name
                        results.append(_emit("payload", cell, device))
            finally:
                gw.close()
    return results


def payload_speedup(payload_results) -> Dict[str, Optional[float]]:
    """In-place over legacy requests/s a (transport, size, in-flight), keyed
    ``"<transport>/<KiB>KiB/k<in_flight>"`` as the reference keys its
    ``zero_copy_speedup``."""
    by = {(r["transport"], r["payload_bytes"], r["in_flight"], r["mode"]): r
          for r in payload_results}
    return {f"{t}/{nb >> 10}KiB/k{k}": _ratio(r, by.get((t, nb, k, "legacy")))
            for (t, nb, k, mode), r in sorted(by.items()) if mode == "zero_copy"}


def zero_copy_gate(speedup: Dict[str, Optional[float]]) -> Optional[bool]:
    """The reference's ``zero_copy_gate_mpklink_opt_1p5x``: every
    mpklink_opt cell at ``PAYLOAD_IN_FLIGHT`` in flight at least 1.5x
    (None without payload cells). Reported, never enforced here."""
    if not speedup:
        return None
    opt = [v for key, v in speedup.items() if key.startswith("mpklink_opt/")
           and key.endswith(f"/k{PAYLOAD_IN_FLIGHT}")]
    return bool(opt) and None not in opt and min(opt) >= 1.5


def sweep_scatter(transport, n_services, rounds, workers_list,
                  device="cuda") -> List[Dict]:
    cells = [("sequential", 0)] + [("scatter", w) for w in workers_list]
    return [_emit("scatter", run_scatter_cell(transport, w, n_services, rounds,
                                              mode, device), device)
            for mode, w in cells]


def sweep_fanin(transports, clients_list, reps_by_count,
                device="cuda") -> List[Dict]:
    return [_emit("fanin", run_fanin_cell(name, n, reps_by_count[n], coalesce,
                                          device), device)
            for name in transports for n in clients_list
            for coalesce in (False, True)]


def _ratio(a: Optional[dict], b: Optional[dict]) -> Optional[float]:
    if not a or not b or not b.get("throughput_rps"):
        return None
    return round(a["throughput_rps"] / b["throughput_rps"], 2)


def summarize(results, batch_results, scatter_results, fanin_results) -> dict:
    """The reference's ratios: 16 over 1 client, batched 16 over lockstep,
    scatter over sequential, coalesced over inline (and its wakeup
    reduction)."""
    by = {(r["transport"], r["service"], r["clients"]): r for r in results}
    scaling = {f"{t}/{s}": _ratio(r, by.get((t, s, 1)))
               for (t, s, n), r in by.items() if n == 16}
    bb = {(r["transport"], r["service"], r["mode"], r["in_flight"]): r
          for r in batch_results}
    batch = {f"{t}/{s}": _ratio(r, bb.get((t, s, "lockstep", 1)))
             for (t, s, m, k), r in bb.items() if m == "batched" and k == 16}
    base = next((r for r in scatter_results if r["mode"] == "sequential"), None)
    scatter = {f"workers{r['workers']}": _ratio(r, base)
               for r in scatter_results if r["mode"] == "scatter"}
    fb = {(r["transport"], r["clients"], r["mode"]): r for r in fanin_results}
    fanin: Dict[str, Optional[float]] = {}
    for (t, n, m), r in fb.items():
        if m != "coalesced":
            continue
        inline = fb.get((t, n, "inline"))
        fanin[f"{t}/{n}c"] = _ratio(r, inline)
        if inline and inline.get("wakeups_per_request") is not None \
                and r.get("wakeups_per_request") is not None:
            fanin[f"{t}/{n}c_wakeup_reduction"] = round(
                inline["wakeups_per_request"]
                / max(r["wakeups_per_request"], 1e-3), 2)
    return {"scaling_16c_over_1c": scaling,
            "batch_speedup_16_over_lockstep": batch,
            "batch_gate_mpklink_opt_2x": None if not batch_results
            else (batch.get("mpklink_opt/wordcount") or 0) >= 2.0,
            "scatter_speedup_vs_sequential": scatter,
            "scatter_gate_workers4_2x": None if not scatter_results
            else (scatter.get("workers4") or 0) >= 2.0,
            "fanin_speedup_coalesced_over_inline": fanin,
            "coalesce_gate_mpklink_opt_64c_2x": None if not fanin_results
            else (fanin.get("mpklink_opt/64c") or 0) >= 2.0,
            "coalesce_wakeup_gate_4x": None if not fanin_results
            else (fanin.get("mpklink_opt/64c_wakeup_reduction") or 0) >= 4.0,
            "all_macs_verified": all(r["all_macs_verified"] for r in
                                     results + batch_results + fanin_results)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="mpklink variants only, clients <= 16, fewer reps")
    ap.add_argument("--no-infer", action="store_true",
                    help="skip the EngineService-backed service")
    ap.add_argument("--no-batch", action="store_true",
                    help="skip the pipelined batch sweep")
    ap.add_argument("--no-payload", action="store_true",
                    help="skip the large-payload sweep")
    ap.add_argument("--no-scatter", action="store_true",
                    help="skip the sharded-executor scatter sweep")
    ap.add_argument("--no-fanin", action="store_true",
                    help="skip the high-fan-in coalescing sweep")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    device = args.device
    kind = (torch.cuda.get_device_name(torch.device(device))
            if _on_card(device) else "cpu")
    print(f"# device {torch.device(device)} ({kind}), "
          f"os.cpu_count() {os.cpu_count()}", flush=True)

    q = args.quick
    transports = ["mpklink", "mpklink_opt"] if q else TRANSPORTS_ORDER
    clients = [c for c in CLIENTS if c <= (16 if q else 64)]
    engine_service = None if args.no_infer else build_engine_service(device=device)
    try:
        results = sweep(transports, clients, 4 if q else 8, 2 if q else 6,
                        engine_service, device)
        batch_results = [] if args.no_batch else sweep_batch(
            ["mpklink_opt"] if q else ["mpklink", "mpklink_opt"],
            32 if q else 64, 8 if q else 16, engine_service, device)
    finally:
        if engine_service is not None:
            engine_service.close()
    payload_results = [] if args.no_payload else sweep_payload(
        ["mpklink_opt"] if q else ["mpklink", "mpklink_opt"],
        PAYLOAD_SIZES[:2] if q else PAYLOAD_SIZES, 6 if q else 12, device)
    zc_speedup = payload_speedup(payload_results)
    scatter_results = [] if args.no_scatter else sweep_scatter(
        "mpklink_opt", SCATTER_SERVICES, 12 if q else 30, [0, 4], device)
    fanin_results = [] if args.no_fanin else sweep_fanin(
        ["mpklink_opt"], [64] if q else FANIN_CLIENTS,
        {64: 3, 256: 2} if q else {64: 8, 256: 4}, device)
    report = {"meta": {"device": str(torch.device(device)), "device_name": kind,
                       **_host(), "clients": clients, "transports": transports,
                       "wordcount_words": WORDS, "prompt_len": PROMPT_LEN,
                       "max_new": MAX_NEW},
              **summarize(results, batch_results, scatter_results, fanin_results),
              "zero_copy_speedup": zc_speedup,
              "zero_copy_gate_mpklink_opt_1p5x": zero_copy_gate(zc_speedup),
              "results": results, "batch_results": batch_results,
              "payload_results": payload_results,
              "scatter_results": scatter_results, "fanin_results": fanin_results}
    blob = json.dumps(report)
    print(blob, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob)
    if not q:       # the reference enforces its gates on full runs only
        for gate in ("batch_gate_mpklink_opt_2x", "scatter_gate_workers4_2x",
                     "coalesce_gate_mpklink_opt_64c_2x",
                     "coalesce_wakeup_gate_4x"):
            if report[gate] is False:
                raise SystemExit(f"gate failed: {gate}")
    return report


if __name__ == "__main__":
    main()
