"""The paper's distributed word count over the port's six transports (the
twin of ``benchmarks/ipc_wordcount.py``; Fig. 1–3 and Table I of the
paper, with mpklink_opt as the sixth).

    python -m repro_torch.launch.ipc_wordcount [--device cuda] [--full] [--reps 3]

Each point is the median round trip (request → count on the device →
response) of ``reps`` lockstep requests through a fresh transport, after
one untimed one-word exchange that makes the session's stream and kernel
workspaces. The text of each size is made once and sent through every
transport. Every count must be exact; every point also reports the key
syncs and guard-kernel launches per request, which must equal the counts
the transports' code gives (:func:`lockstep_syncs`,
:func:`lockstep_launches`). ``--full`` adds 1e7 words for all six and the
paper's endpoint, 1e8 words (one rep), for uds, mpklink and mpklink_opt.
The CSV rows and :func:`validate_claims` (claims 1–5) are the reference's;
claims 1, 2 and 5 are timings and depend on the host (print
``os.cpu_count()`` beside them). :func:`concurrent_sessions` and
:func:`region_checks` are the card run's concurrency and region checks.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import TRANSPORTS, framing
from repro_torch.core.transports import CapacityError
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler
from repro_torch.kernels import mpk_guard, ops

WORD_COUNTS = [100, 1_000, 10_000, 100_000, 1_000_000]
WORD_COUNTS_FULL = WORD_COUNTS + [10_000_000]
ENDPOINT = 100_000_000                       # the paper's largest request
ENDPOINT_TRANSPORTS = ("uds", "mpklink", "mpklink_opt")
ORDER = ["pipe", "uds", "shm", "grpc_sim", "mpklink", "mpklink_opt"]
MPK = ("mpklink", "mpklink_opt")
MPK_PROC = ("mpklink_proc", "mpklink_opt_proc")     # core.procwire's pair
COUNT_BYTES = 8                              # a response: the count as uint64


def _seal_launches(nbytes: int) -> Dict[str, int]:
    """Launches of ``framing.seal_into`` for an ``nbytes`` payload: the
    streaming MAC (``fast_mac``)."""
    rows = framing.frame_rows(nbytes) - 1
    return {"mac_init_state": 1, "mac_finalize": 1,
            "mac_update": math.ceil(rows / framing.FAST_MAC_BLOCK_ROWS)}


def _add(*counts: Dict[str, int]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def lockstep_launches(name: str, nbytes: int, device) -> Dict[str, int]:
    """Guard-kernel launches of one lockstep request on the card: the mpklink
    pair seals the request (client) and the response (service) and verifies
    each with one ``guard_copy``; the other transports have no MAC. None on
    the CPU, where the plain versions run."""
    if torch.device(device).type != "cuda" or name not in MPK:
        return {}
    return _add(_seal_launches(nbytes), _seal_launches(COUNT_BYTES),
                {"guard_copy": 2})


def proc_launches(name: str, nbytes: int, device) -> tuple:
    """Guard-kernel launches of one lockstep request over a process
    transport, as ``(parent, child)``: the parent seals the request and
    verifies the response with one ``guard_copy``, the service child
    verifies the request and seals the response. Empty on the CPU and for
    the transports without MPK."""
    if torch.device(device).type != "cuda" or name not in MPK_PROC:
        return {}, {}
    return (_add(_seal_launches(nbytes), {"guard_copy": 1}),
            _add(_seal_launches(COUNT_BYTES), {"guard_copy": 1}))


def _mac_batch_launches(nbytes: Sequence[int]) -> int:
    """``framing.mac_batch`` launches for frames of these payload sizes: one
    per row count, per ``MAX_BATCH_FRAMES`` frames."""
    groups: Dict[int, int] = {}
    for n in nbytes:
        rows = framing.frame_rows(n)
        groups[rows] = groups.get(rows, 0) + 1
    return sum(math.ceil(k / mpk_guard.MAX_BATCH_FRAMES) for k in groups.values())


def ring_launches(req_nbytes: Sequence[int], device) -> Dict[str, int]:
    """Guard-kernel launches of one ``call_batch`` window through an mpklink
    ring drained in one pass: the requests are sealed (client) and verified
    (service), the responses sealed (service) and verified (client), each
    step one ``mac_batch`` launch per row count."""
    if torch.device(device).type != "cuda":
        return {}
    return {"mac_batch": 2 * _mac_batch_launches(req_nbytes)
            + 2 * _mac_batch_launches([COUNT_BYTES] * len(req_nbytes))}


def lockstep_syncs(tr, nbytes: int) -> int:
    """PKRU key syncs of one lockstep request: one a ``chunk`` of the
    request frame, one on the response side (0 without MPK; the process
    transports keep the schedule)."""
    if tr.name not in MPK + MPK_PROC:
        return 0
    chunk_rows = max(1, tr.chunk // (framing.LANES * 4))
    return math.ceil(framing.frame_rows(nbytes) / chunk_rows) + 1


def text_of(n_words: int) -> np.ndarray:
    """The request text of a size (the reference's seed)."""
    return make_text(n_words, seed=n_words % 97)


def measure(name: str, n_words: int, reps: int = 3, device="cuda",
            text: Optional[np.ndarray] = None) -> Optional[dict]:
    """Median round trip of ``reps`` requests of ``n_words`` words
    (``text``, or :func:`text_of`) through a fresh ``name`` transport, with
    the bytes, key syncs and guard-kernel launches per request (checked
    against the counts the code gives); None when the transport refuses
    the payload (shm's capacity)."""
    text = text_of(n_words) if text is None else text
    tr = TRANSPORTS[name](wordcount_handler, device=device)
    tr.start()
    try:
        tr.request(make_text(1, seed=0))         # stream, workspaces: untimed
        syncs0 = getattr(tr, "sync_count", 0)
        ops.LAUNCHES.reset()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            resp = tr.request(text)
            ts.append(time.perf_counter() - t0)
            got = parse_count(resp)
            if got != n_words:
                raise RuntimeError(f"{name}: counted {got} of {n_words} words")
        launches = {k: v / reps for k, v in ops.LAUNCHES.snapshot().items() if v}
        syncs = (getattr(tr, "sync_count", 0) - syncs0) / reps
    except CapacityError:
        return None
    finally:
        tr.close()
    want_launches = lockstep_launches(name, text.nbytes, device)
    want_syncs = lockstep_syncs(tr, text.nbytes)
    if launches != want_launches or syncs != want_syncs:
        raise RuntimeError(
            f"{name} at {n_words} words: {syncs} key syncs and launches "
            f"{launches} a request, the code gives {want_syncs} and "
            f"{want_launches}")
    return {"transport": name, "n_words": n_words, "bytes": int(text.nbytes),
            "seconds": sorted(ts)[len(ts) // 2], "reps": reps,
            "key_syncs_per_request": syncs, "launches_per_request": launches}


def sweep(word_counts: Sequence[int], reps: int = 3, device="cuda",
          endpoint: bool = False, emit=None) -> Dict[str, Dict[int, Optional[float]]]:
    """{transport: {n_words: seconds or None}} over ``word_counts`` (and
    the 1e8-word endpoint for :data:`ENDPOINT_TRANSPORTS`); ``emit`` gets
    each point's record."""
    out: Dict[str, Dict[int, Optional[float]]] = {name: {} for name in ORDER}
    points = [(n, ORDER, reps) for n in word_counts]
    if endpoint:
        points.append((ENDPOINT, ENDPOINT_TRANSPORTS, 1))
    for n, names, r in points:
        text = text_of(n)                        # made once a size
        for name in names:
            rec = measure(name, n, r, device, text)
            out[name][n] = None if rec is None else rec["seconds"]
            if emit is not None:
                emit(rec if rec is not None else
                     {"transport": name, "n_words": n, "bytes": int(text.nbytes),
                      "seconds": None, "refused": "CapacityError"})
        del text
    return out


def validate_claims(results, device="cuda") -> List[str]:
    """The paper's qualitative claims against measured data (the
    reference's claims 1–5) → 'claim: PASS/FAIL' lines."""
    lines = []
    mpk, pipe = results["mpklink"], results["pipe"]
    shm, uds = results["shm"], results["uds"]

    c1 = mpk[100] is not None and pipe[100] is not None and \
        mpk[100] < pipe[100] * 1.5
    lines.append(f"claim1 (MPKLink competitive with pipes at ≤100 words): "
                 f"{'PASS' if c1 else 'DEVIATION'} "
                 f"(mpk={mpk[100]:.2e}s pipe={pipe[100]:.2e}s)")

    small = [n for n in mpk if n <= 10_000 and shm.get(n) is not None]
    c2 = all(mpk[n] >= min(shm[n], uds[n]) * 0.8 for n in small)
    lines.append(f"claim2 (shm/UDS faster than MPKLink at small sizes): "
                 f"{'PASS' if c2 else 'FAIL'}")

    c3 = shm[100_000] is None
    lines.append(f"claim3 (raw shm incapable of ≥100k words): "
                 f"{'PASS' if c3 else 'FAIL'}")

    c4 = mpk[100_000] is not None
    lines.append(f"claim4 (MPKLink handles ≥100k words): "
                 f"{'PASS' if c4 else 'FAIL'}")

    # claim 5 in the sync-bound regime, re-measured with 9 reps
    text = text_of(1_000_000)
    t_chunked = measure("mpklink", 1_000_000, 9, device, text)["seconds"]
    t_batched = measure("mpklink_opt", 1_000_000, 9, device, text)["seconds"]
    c5 = t_batched < t_chunked
    lines.append(f"claim5 (beyond-paper: batched key sync beats per-chunk sync "
                 f"in the sync-bound regime, 1e6 words, 9-rep median): "
                 f"{'PASS' if c5 else 'FAIL'} "
                 f"({t_chunked:.4f}s -> {t_batched:.4f}s)")
    return lines


def table_rows(results):
    """CSV rows: figure/table tag, transport, n_words, seconds."""
    rows = []
    for name, series in results.items():
        for n, t in series.items():
            tag = "fig3" if n <= 10_000 else "fig2"
            rows.append((tag, name, n, t))
    # Table I: MPKLink vs the best other transport measured at that size
    for n in sorted({n for series in results.values() for n in series}):
        others = {k: v[n] for k, v in results.items()
                  if k not in MPK and v.get(n) is not None}
        if not others or results["mpklink"].get(n) is None:
            continue
        best = min(others, key=others.get)
        rows.append(("table1", f"mpklink_vs_{best}", n,
                     results["mpklink"][n] / others[best]))
    return rows


def concurrent_sessions(n_sessions: int = 16, batch: int = 8,
                        n_words: int = 10_000, rounds: int = 4,
                        device="cuda") -> dict:
    """``n_sessions`` mpklink_opt sessions at once, each running ``rounds``
    ``call_batch`` calls of ``batch`` requests through its ring: requests/s,
    wakeups and key syncs per request (``framing.STATS``), p50/p99 of a
    batch's round trip. Every count must be exact, and the key syncs and
    ``mac_batch`` launches must equal what the code gives (one flush sync
    and one drain-pass sync a batch)."""
    tr = TRANSPORTS["mpklink_opt"](wordcount_handler, device=device,
                                   ring_slots=batch, max_keys=4 * n_sessions)
    sessions = [tr.connect(f"c{i}") for i in range(n_sessions)]
    texts = [make_text(n_words + j, seed=j) for j in range(batch)]
    for s in sessions:                          # untimed warm-up batch
        s.call_batch(texts[:1])
    lat: List[float] = []
    errors: List[str] = []
    lock = threading.Lock()
    start = threading.Barrier(n_sessions + 1)

    def client(s):
        try:
            start.wait(timeout=60)
            for _ in range(rounds):
                t0 = time.perf_counter()
                outs = s.call_batch(texts)
                dt = time.perf_counter() - t0
                got = [parse_count(o) for o in outs]
                if got != [n_words + j for j in range(batch)]:
                    raise RuntimeError(f"session {s.name} counted {got}")
                with lock:
                    lat.append(dt)
        except BaseException as e:          # noqa: B036 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(s,)) for s in sessions]
    for t in threads:
        t.start()
    st0, syncs0 = framing.STATS.snapshot(), tr.sync_count
    ops.LAUNCHES.reset()
    start.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    alive = sum(t.is_alive() for t in threads)
    launches = {k: v for k, v in ops.LAUNCHES.snapshot().items() if v}
    st1 = framing.STATS.snapshot()
    tr.close()
    if errors or alive:
        raise RuntimeError(f"concurrent sessions failed ({alive} hung): {errors}")
    n_req = n_sessions * rounds * batch
    syncs = tr.sync_count - syncs0
    want = ring_launches([t.nbytes for t in texts], device)
    want = {k: v * n_sessions * rounds for k, v in want.items()}
    if syncs != 2 * n_sessions * rounds or launches != want:
        raise RuntimeError(f"{syncs} key syncs and launches {launches} for "
                           f"{n_sessions * rounds} batches; the code gives "
                           f"{2 * n_sessions * rounds} and {want}")
    lat.sort()
    return {"sessions": n_sessions, "batch": batch, "n_words": n_words,
            "rounds": rounds, "requests": n_req, "wall_s": wall,
            "requests_per_s": n_req / wall,
            "wakeups_per_request": (st1["wakeups"] - st0["wakeups"]) / n_req,
            "doorbell_parks_per_request":
                (st1["doorbell_parks"] - st0["doorbell_parks"]) / n_req,
            "key_syncs_per_request": (st1["key_syncs"] - st0["key_syncs"]) / n_req,
            "batch_p50_s": lat[len(lat) // 2],
            "batch_p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "launches": launches}


def region_checks(device="cuda", n_words: int = 10_000) -> dict:
    """Frames sealed in an mpklink session's regions on ``device`` equal the
    frames the CPU's plain path seals with the same seed and sequence, bit
    for bit, and verify there; a byte flipped in a region on ``device`` is
    refused by the guard there."""
    text = make_text(n_words, seed=5)
    tr = TRANSPORTS["mpklink"](wordcount_handler, device=device)
    tr.start()
    try:
        s = tr._default
        resp = s.request(text)
        req_rows = framing.frame_rows(text.nbytes)
        resp_rows = framing.frame_rows(COUNT_BYTES)
        regions = {"request": (s._region_req[:req_rows], text),
                   "response": (s._region_resp[:resp_rows], np.asarray(
                       [n_words], "<u8").view(np.uint8))}
        for what, (region, payload) in regions.items():
            on_cpu = region.cpu()
            want = framing.build_frame(payload, seed=s.seed, seq=0, device="cpu")
            if not torch.equal(on_cpu.view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"the {what} frame sealed on {device} differs "
                                   f"from the CPU's")
            got = framing.verify_view(on_cpu, seed=s.seed, expect_seq=0)
            if not np.array_equal(got.numpy(), payload):
                raise RuntimeError(f"the {what} frame does not verify on the CPU")
        bad = s._region_req[:req_rows].clone()
        bad.view(torch.uint8).reshape(-1)[512 + 777] ^= 0x20
        try:
            framing.verify_view(bad, seed=s.seed, expect_seq=0)
        except framing.FrameError:
            refused = True
        else:
            raise RuntimeError(f"a tampered region verified on {device}")
    finally:
        tr.close()
    return {"n_words": n_words, "count": parse_count(resp),
            "request_rows": req_rows, "bit_identical_on_cpu": True,
            "tampered_refused": refused}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="add 1e7 words and the 1e8-word endpoint; slow")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    device = args.device
    print(f"# device {torch.device(device)}, os.cpu_count() {os.cpu_count()}")
    results = sweep(WORD_COUNTS_FULL if args.full else WORD_COUNTS, args.reps,
                    device, endpoint=args.full,
                    emit=lambda rec: print(json.dumps(rec), flush=True))
    print("figure,transport,n_words,seconds")
    for tag, name, n, t in table_rows(results):
        print(f"{tag},{name},{n},{'' if t is None else f'{t:.6f}'}")
    print()
    for line in validate_claims(results, device):
        print("#", line)
    return results


if __name__ == "__main__":
    main()
