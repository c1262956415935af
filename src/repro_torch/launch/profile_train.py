"""Where a training step's time goes, on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_train \
      [--arch mamba2-1.3b] [--micro 1] [--seq 2048] [--trace out.json]

One ``make_train_step`` at the shape ``chip_smoke.py`` trains: ``--arch``
(default llama3.2-1b) at full width and depth, f32 parameters and AdamW
moments, bf16 compute, a global batch of 8 x ``--seq`` tokens (default
2048; chip_smoke trains whisper-tiny at 448, over 1500 frames a row) in
microbatches of ``--micro`` (default 2; chip_smoke trains zamba2-2.7b at
1), on the synthetic stream (random weights from seed 0). After two
warm-up steps it reports as JSON lines:

* ``step``   — host-clock ms per step over 3 steps, tokens/s, peak memory;
* ``device`` — one more step under ``torch.profiler``: the device's busy
  time and idle share, the device time of the step's ranges (the forward
  passes and the optimizer; the backward runs on autograd's own thread, so
  its share is the busy time the other two leave), the device time by
  kernel family (matched by kernel name), and the top kernels.

Writes the chrome trace to ``--trace`` when given.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCH_IDS, OptimizerConfig, TrainConfig, get_config
from repro_torch.data import SyntheticDataset, to_device
from repro_torch.device import resolve
from repro_torch.models import init_params
from repro_torch.optim import init_opt_state
from repro_torch.runtime.steps import make_train_step

BATCH, SEQ, STEPS = 8, 2048, 3

# kernel families by name (case-insensitive), first match wins
FAMILIES = (
    ("flash_attention_bwd", r"flash_bwd"),
    ("flash_attention", r"flash_fwd"),
    ("ssd_scan_bwd", r"ssd_bwd|ssd_dstate_pass|ssd_states_mma<true>"),
    ("ssd_scan", r"ssd_states_mma|ssd_state_pass|ssd_output_mma"),
    ("gemm", r"gemm|nvjet|xmma|cutlass|cublas|sm90_"),
    ("softmax_cross_entropy", r"softmax|nll_loss|cross_entropy"),
    ("reduce", r"reduce|norm"),
    ("copy_cat_memcpy", r"copy|memcpy|cat"),
    ("elementwise", r"elementwise|index|gather|scatter|fill"),
)


def _family(name: str) -> str:
    return next((f for f, pat in FAMILIES if re.search(pat, name, re.I)), "other")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCH_IDS))
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    dev = resolve("cuda")
    cfg = get_config(args.arch)
    tcfg = TrainConfig(microbatch_size=args.micro, dtype="bfloat16",
                       optimizer=OptimizerConfig(lr=3e-4, warmup_steps=2,
                                                 total_steps=100))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = init_opt_state(params)
    step = make_train_step(cfg, tcfg)
    data = SyntheticDataset(cfg, args.seq, seed=0)
    batches = [to_device(data.batch(i, BATCH), dev) for i in range(STEPS + 3)]
    for b in batches[:2]:                                # warm-up
        step(params, opt, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    for b in batches[2:2 + STEPS]:
        step(params, opt, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"phase": "step", "arch": cfg.name, "nvidia_smi": smi,
                      "global_batch": BATCH, "seq_len": args.seq,
                      "microbatch": args.micro, "steps": STEPS, "ms_per_step": step_ms,
                      "tokens_per_s": BATCH * args.seq / step_ms * 1e3,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batches[-1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the step's ranges show on the device timeline too: not kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("train_step.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ranges = {e.key: e.device_time_total / 1e3 for e in events
              if e.key.startswith("train_step.")}
    families = {}
    for e in kernels:
        f = _family(e.key)
        families[f] = families.get(f, 0.0) + e.self_device_time_total / 1e3
    fwd, optim = ranges.get("train_step.forward", 0.0), ranges.get("train_step.optimizer", 0.0)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    print(json.dumps({
        "phase": "device", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "device_idle_share_vs_unprofiled_step": 1 - busy_ms / step_ms,
        "forward_ms": fwd, "optimizer_ms": optim,
        "backward_ms_by_difference": busy_ms - fwd - optim,
        "families_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in top]}),
          flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
