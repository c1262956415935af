"""Serving launcher: continuous-batching decode over a fixed slot grid, on
the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --full

Weights are random, drawn from seed 0, in bfloat16. ``--device cpu`` runs
the plain versions of the kernels. ``--max-seq`` defaults to 96, or to the
sliding window where the model's is shorter: the engine's slots decode at
positions of their own, which a ring cache (past the window) cannot hold.
llava-next-mistral-7b is served on text prompts. A model whose bf16
weights exceed the card's memory is refused with the sizes (mixtral-8x7b
at all 32 layers, grok-1-314b), and what the engine refuses is refused
with its reason: a ``--max-seq`` past the window, or an encoder-decoder
(whisper-tiny decodes through ``runtime.steps.make_decode_step``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.device import card_memory, check_fits, resolve
from repro_torch.kernels import ops
from repro_torch.models import init_params
from repro_torch.runtime import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    dtype = torch.bfloat16
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    max_seq = args.max_seq or min(96, cfg.swa_window or 96)
    try:
        check_fits(f"serving {cfg.name} (bf16 weights)", 2 * cfg.param_count(),
                   card_memory(dev))
    except ValueError as e:
        ap.error(str(e))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=dtype)
    try:
        eng = ServingEngine(cfg, params, max_batch=args.max_batch,
                            max_seq=max_seq, dtype=dtype, device=dev)
    except ValueError as e:             # what the engine does not serve
        ap.error(str(e))

    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = [(13 * i + j) % cfg.vocab_size for j in range(3 + i % 4)]
        eng.submit(Request(rid=i, prompt=prompt, max_new=args.max_new))
    done = eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    total = sum(len(r.generated) for r in done)
    for r in sorted(done, key=lambda r: r.rid)[:8]:
        print(f"req {r.rid:2d}: prompt={len(r.prompt)} new={len(r.generated)} "
              f"latency={(r.finished_at - r.submitted_at)*1e3:7.1f} ms")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"\n{cfg.name} on {where} | {len(done)} requests | {total} tokens | "
          f"{eng.ticks} ticks | {wall:.2f}s | {total/wall:.1f} tok/s")
    print(f"kernel launches: {ops.LAUNCHES.snapshot()}")


if __name__ == "__main__":
    main()
