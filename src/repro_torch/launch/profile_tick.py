"""Where an engine tick's time goes, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_tick [--trace out.json]

Fills every slot of a ``ServingEngine`` running llama3.2-1b at full width
and depth in bfloat16 (random weights from seed 0; 8 slots, max_seq 1024,
prompts of 16 tokens), warms up, then reports as JSON lines:

* ``tick``   — host-clock ms per tick over 20 ticks;
* ``device`` — over 20 more ticks under ``torch.profiler``: the device's
  busy time per tick, its idle share (against the profiled wall time, and
  against the unprofiled tick, since the profiler slows the host), and the
  top kernels and host operators by time.

Writes the chrome trace to ``--trace`` when given.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models import init_params
from repro_torch.runtime import Request, ServingEngine

ARCH, MAX_BATCH, MAX_SEQ, PROMPT, TICKS = "llama3.2-1b", 8, 1024, 16, 20


def _top(events, key, ticks, n=12):
    rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)[:n]
    return [{"name": e.key[:80], "calls_per_tick": e.count / ticks,
             "ms_per_tick": getattr(e, key) / 1e3 / ticks} for e in rows]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    dev = resolve("cuda")
    cfg = get_config(ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    eng = ServingEngine(cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                        dtype=torch.bfloat16, device=dev)
    for b in range(MAX_BATCH):
        eng.submit(Request(rid=b, prompt=[(7 * b + j) % cfg.vocab_size
                                          for j in range(PROMPT)],
                           max_new=2 * TICKS + 5))
    for _ in range(5):                                  # warm-up
        eng.tick()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(TICKS):
        eng.tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / TICKS * 1e3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"phase": "tick", "arch": cfg.name, "nvidia_smi": smi,
                      "max_batch": MAX_BATCH, "ticks": TICKS,
                      "ms_per_tick": tick_ms}), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TICKS):
            eng.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(json.dumps({
        "phase": "device", "ticks": TICKS, "wall_ms_per_tick": wall_ms / TICKS,
        "device_busy_ms_per_tick": busy_us / 1e3 / TICKS,
        "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
        "device_idle_share_vs_unprofiled_tick":
            1 - busy_us / 1e3 / TICKS / tick_ms,
        "top_kernels": _top(kernels, "self_device_time_total", TICKS),
        "top_host_ops": _top([e for e in events if e.device_type ==
                              torch.autograd.DeviceType.CPU],
                             "self_cpu_time_total", TICKS)}), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
