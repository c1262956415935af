"""Training launcher: the Trainer end to end (microbatching, checkpointing,
failure injection, straggler telemetry), on the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.train --full
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --full --ckpt-dir ckpt \\
      --fail-at 4

``--full`` trains the architecture at its published size in bf16 compute
(on the card: flash attention's and the SSD scan's forward and backward
kernels in every layer); without it, the reduced twin in f32 compute.
Parameters and AdamW moments are f32, except where the reference's dry run
keeps them in bf16 (``TRAIN_PARAM_DTYPE`` / ``TRAIN_OPT_DTYPE`` of
``launch.dryrun``, the reference's tables: grok-1-314b), reduced or not. Weights
are random, drawn from ``--seed``; the data is ``SyntheticDataset`` (with
a VLM's patch embeddings and an encoder-decoder's frames: whisper-tiny
trains on 1500 frames a row). On a card, a model whose training state
(parameters, gradients and two moments, ``train_bytes_per_param``) and
one microbatch's activations exceed the card's memory is refused with
the dry run's bytes (``launch.dryrun.fits_depth``, on the meta device)
and the depth that would fit (qwen3-14b, mixtral-8x7b, grok-1-314b,
llava-next-mistral-7b at their published depths; a cut depth trains only
through ``chip_smoke.py``'s constants).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import (ARCH_IDS, OptimizerConfig, TrainConfig,
                                 get_config, get_reduced)
from repro_torch.device import MetaGenerator, card_memory
from repro_torch.launch.dryrun import TRAIN_OPT_DTYPE, TRAIN_PARAM_DTYPE, fits_depth
from repro_torch.models import Impl, init_params
from repro_torch.runtime import FailureInjector, Trainer
from repro_torch.runtime.steps import train_grad_dtype
from repro_torch.tree import leaves


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def train_bytes_per_param(param_dtype: torch.dtype, opt_dtype: torch.dtype,
                          n_micro: int = 1) -> int:
    """Bytes of training state a parameter: the parameter, its gradient
    (``runtime.steps.train_grad_dtype``) and AdamW's two moments: 16 in
    f32, 8 with bf16 parameters and moments."""
    return (param_dtype.itemsize + train_grad_dtype(param_dtype, n_micro).itemsize
            + 2 * opt_dtype.itemsize)


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
    pdt = TRAIN_PARAM_DTYPE.get(args.arch, torch.float32)
    odt = TRAIN_OPT_DTYPE.get(args.arch, torch.float32)
    n_micro = max(1, batch // micro)
    gdt = train_grad_dtype(pdt, n_micro)
    per = train_bytes_per_param(pdt, odt, n_micro)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"({'full' if full else 'reduced'}) on {args.device}, "
          f"{_name(pdt)} parameters, {_name(odt)} moments")
    capacity = card_memory(args.device)
    if capacity is not None:
        plan = fits_depth(cfg, "train", batch, seq, capacity, micro=micro,
                          param_dtype=pdt, opt_dtype=odt,
                          dtype=torch.bfloat16 if full else torch.float32, impl=Impl())
        if plan["need_bytes"] > capacity:
            state = per * sum(t.numel() for t in leaves(init_params(cfg, MetaGenerator())))
            ap.error(f"training {cfg.name} ({_name(pdt)} parameters, {_name(gdt)} "
                     f"gradients, {_name(odt)} AdamW moments, {per} bytes a parameter) "
                     f"needs {state / 1e9:.1f} GB of state and "
                     f"{(plan['need_bytes'] - state) / 1e9:.1f} GB of activations "
                     f"(the dry run), more than the card's {capacity / 1e9:.1f} GB; "
                     f"{plan['fits_depth']} of its {cfg.num_layers} layers would fit; "
                     f"it needs the multi-device fabric")

    tcfg = TrainConfig(
        microbatch_size=micro, dtype="bfloat16" if full else "float32",
        param_dtype=_name(pdt),
        optimizer=OptimizerConfig(lr=lr, warmup_steps=max(2, steps // 20),
                                  total_steps=steps,
                                  weight_decay=0.1 if full else 0.01),
        log_every=1 if full else max(1, steps // 20),
        checkpoint_every=max(10, steps // 5), seed=args.seed)
    injector = FailureInjector({args.fail_at: ["host1"]} if args.fail_at else {})
    trainer = Trainer(cfg, tcfg, global_batch=batch, seq_len=seq,
                      checkpoint_dir=args.ckpt_dir,
                      workers=[f"host{i}" for i in range(4)], injector=injector,
                      device=args.device, opt_dtype=odt)
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
