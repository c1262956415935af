"""The guard MAC kernels' block settings, timed on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.mac_sweep \
      [--chunks 64,128,256,512,1024] [--threads 128,256,512]

For every (``MAC_CHUNK_ROWS``, ``MAC_THREADS``) pair of
``kernels/mpk_guard.py`` (rows a block, and the most threads a block:
``mac_threads`` gives a block a warp per 8 rows of its chunk, so a one-row
call runs 128 threads whatever the setting), reports as one JSON line:

* ``update_ms`` — ``mac_update_cuda`` on a 65,536-row block (32 MiB), over
  4 distinct blocks called in turn, so each call finds its block cold in
  the 50 MB L2 (CUDA events around eager calls, so the host's cost per
  call is a floor); ``update_cold_graph_ms`` the same calls, two passes
  over the 4 blocks captured in one CUDA graph and replayed (the device's
  time);
* ``batch_ms`` / ``batch_cold_graph_ms`` — ``mac_batch_cuda`` on a
  (64, 1024, 128) stack (32 MiB), cold in the same way;
* ``update_graph_ms`` / ``batch_graph_ms`` — a one-row block and an
  (8, 1, 128) stack, 20 calls captured in one CUDA graph and replayed.

Every output is checked bit for bit against the plain version. The first
line names the card and its power limit (``nvidia-smi``) and times the
earlier two-launch designs on the same inputs, and a plain read of the
same bytes (``torch.sum`` of the blocks as int32, cold, graph replay) as a
yardstick of the read rate a library kernel reaches; the last gives the
bound, 32 MiB over 3.35 TB/s.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.device import resolve
from repro_torch.kernels import mpk_guard as mg

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
ROTATE = 4                       # distinct inputs called in turn (4 x 32 MiB)


def _u32(shape, gen):
    w = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen, dtype=torch.int64,
                      device="cuda")
    return w.to(torch.int32).view(torch.uint32)


def _ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(calls, reps=10):
    """ms per call of ``calls`` (functions of no argument) captured in one
    CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()                             # makes the workspace on this stream
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for fn in calls:
            fn()
    return _ms(graph.replay, reps) / len(calls)


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _cold(fn, inputs, iters=20):
    calls = [lambda x=x: fn(*x) for x in inputs]
    return _ms(lambda: [c() for c in calls], iters) / len(calls)


def _cold_graph(fn, inputs):
    return _graph_ms([lambda x=x: fn(*x) for x in inputs] * 2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="64,128,256,512,1024")
    ap.add_argument("--threads", default="128,256,512")
    args = ap.parse_args(argv)
    resolve("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(15)
    tag = 0x5EED1234
    h = mg.mac_init_state_cuda(tag, "cuda")
    blocks = [(h, _u32((65536, 128), gen)) for _ in range(ROTATE)]
    stacks = [(_u32((64, 1024, 128), gen), tag) for _ in range(ROTATE)]
    one = (h, _u32((1, 128), gen))
    env = (_u32((8, 1, 128), gen), tag)
    want_u = [mg.mac_update_plain(*b) for b in blocks]
    want_b = [mg.mac_batch_plain(*s) for s in stacks]
    print(json.dumps({"nvidia_smi": smi, "earlier": {
        "update_ms": _cold(mg._mac_update_two_pass, blocks),
        "update_cold_graph_ms": _cold_graph(mg._mac_update_two_pass, blocks),
        "batch_ms": _cold(mg._mac_batch_two_pass, stacks),
        "batch_cold_graph_ms": _cold_graph(mg._mac_batch_two_pass, stacks),
        "update_graph_ms": _graph_ms([lambda: mg._mac_update_two_pass(*one)] * 20),
        "batch_graph_ms": _graph_ms([lambda: mg._mac_batch_two_pass(*env)] * 20)},
        "sum_cold_graph_ms": _cold_graph(
            lambda _, x: x.view(torch.int32).sum(dtype=torch.int32), blocks)}),
        flush=True)
    defaults = (mg.MAC_CHUNK_ROWS, mg.MAC_THREADS)
    try:
        for chunk in (int(c) for c in args.chunks.split(",")):
            for threads in (int(t) for t in args.threads.split(",")):
                mg.MAC_CHUNK_ROWS, mg.MAC_THREADS = chunk, threads
                exact = all(_same(mg.mac_update_cuda(*b), w) for b, w in zip(blocks, want_u))
                exact &= all(_same(mg.mac_batch_cuda(*s), w) for s, w in zip(stacks, want_b))
                exact &= _same(mg.mac_update_cuda(*one), mg.mac_update_plain(*one))
                exact &= _same(mg.mac_batch_cuda(*env), mg.mac_batch_plain(*env))
                print(json.dumps({
                    "chunk_rows": chunk, "threads": threads, "exact": bool(exact),
                    "update_ms": _cold(mg.mac_update_cuda, blocks),
                    "update_cold_graph_ms": _cold_graph(mg.mac_update_cuda, blocks),
                    "batch_ms": _cold(mg.mac_batch_cuda, stacks),
                    "batch_cold_graph_ms": _cold_graph(mg.mac_batch_cuda, stacks),
                    "update_graph_ms": _graph_ms([lambda: mg.mac_update_cuda(*one)] * 20),
                    "batch_graph_ms": _graph_ms([lambda: mg.mac_batch_cuda(*env)] * 20)}),
                    flush=True)
    finally:
        mg.MAC_CHUNK_ROWS, mg.MAC_THREADS = defaults
    print(json.dumps({"bound_ms": (32 << 20) / HBM_BYTES_PER_S * 1e3,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
