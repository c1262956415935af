"""Training launcher: the Trainer end to end (microbatching, checkpointing,
failure injection, straggler telemetry), on the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.train --full
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --full --ckpt-dir ckpt \\
      --fail-at 4

``--full`` trains the architecture at its published size in bf16 compute
over f32 parameters and moments (on the card: flash attention's and the SSD
scan's forward and backward kernels in every layer); without it, the
reduced twin in f32. Weights are random, drawn from ``--seed``; the data is
``SyntheticDataset`` (with a VLM's patch embeddings and an
encoder-decoder's frames: whisper-tiny trains on 1500 frames a row). A
model whose f32 parameters, gradients and two AdamW moments (16 bytes a
parameter) exceed the card's memory is refused with the sizes (qwen3-14b,
mixtral-8x7b, grok-1-314b, llava-next-mistral-7b: they need the
multi-device fabric).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import (ARCH_IDS, OptimizerConfig, TrainConfig,
                                 get_config, get_reduced)
from repro_torch.device import card_memory, check_fits
from repro_torch.runtime import FailureInjector, Trainer

# f32 parameters, gradients and AdamW's two moments
TRAIN_BYTES_PER_PARAM = 16


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=None,
                    help="default: 6 with --full, else 50")
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="default: 2048 with --full, else 64")
    ap.add_argument("--micro", type=int, default=None,
                    help="microbatch; default: 2 with --full, else 4")
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 3e-4 with --full, else 3e-3")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the published configuration (bf16 compute)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    full = args.full
    steps = args.steps or (6 if full else 50)
    batch = args.batch
    seq = args.seq or (2048 if full else 64)
    micro = args.micro or (2 if full else 4)
    lr = args.lr or (3e-4 if full else 3e-3)
    cfg = get_config(args.arch) if full else get_reduced(args.arch)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"({'full' if full else 'reduced'}) on {args.device}")
    try:
        check_fits(f"training {cfg.name} (f32 parameters, gradients and AdamW "
                   f"moments, {TRAIN_BYTES_PER_PARAM} bytes a parameter)",
                   TRAIN_BYTES_PER_PARAM * cfg.param_count(), card_memory(args.device))
    except ValueError as e:
        ap.error(f"{e}; it needs the multi-device fabric")

    tcfg = TrainConfig(
        microbatch_size=micro, dtype="bfloat16" if full else "float32",
        optimizer=OptimizerConfig(lr=lr, warmup_steps=max(2, steps // 20),
                                  total_steps=steps,
                                  weight_decay=0.1 if full else 0.01),
        log_every=1 if full else max(1, steps // 20),
        checkpoint_every=max(10, steps // 5), seed=args.seed)
    injector = FailureInjector({args.fail_at: ["host1"]} if args.fail_at else {})
    trainer = Trainer(cfg, tcfg, global_batch=batch, seq_len=seq,
                      checkpoint_dir=args.ckpt_dir,
                      workers=[f"host{i}" for i in range(4)], injector=injector,
                      device=args.device)
    report = trainer.run(steps)

    k = max(1, min(5, len(report.losses) // 2))
    first, last = np.mean(report.losses[:k]), np.mean(report.losses[-k:])
    print(f"\nloss {first:.4f} → {last:.4f} | steps {report.steps_run} | "
          f"restarts {report.restarts} | stragglers {report.stragglers} | "
          f"guard trips {report.guard_trips}")
    for e in report.events:
        print("event:", e)


if __name__ == "__main__":
    main()
