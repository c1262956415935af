"""End-to-end training driver: a smollm-family model trained for a few
hundred steps with the full production loop — microbatched steps, cosine
schedule, checkpointing, an injected mid-run failure with automatic restart
from the last checkpoint, and straggler telemetry — on the port's
``Trainer`` (flash attention forward and backward on the card).

Model size scales with ``--width`` (the default is about 2M parameters;
``--width 960 --layers 32`` is the real smollm-360m).

    python -m repro_torch.examples.train_e2e [--device cuda] [--steps 300]
        [--width 128] [--layers 4] [--fail-at 120]
"""
from __future__ import annotations

import tempfile

import numpy as np

from repro_torch.configs import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.device import resolve
from repro_torch.examples._common import check, parser
from repro_torch.kernels import ops
from repro_torch.models import Impl
from repro_torch.runtime import FailureInjector, Trainer


def build_config(width: int, layers: int) -> ModelConfig:
    heads = max(2, width // 64)
    return ModelConfig(
        name=f"smollm-e2e-{width}x{layers}",
        family="dense",
        num_layers=layers,
        d_model=width,
        num_heads=heads,
        num_kv_heads=max(1, heads // 3),
        head_dim=width // heads,
        d_ff=width * 8 // 3 // 16 * 16 or 64,
        vocab_size=2048,
        tie_embeddings=True,
    )


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=120,
                    help="inject a worker failure at this step (0 = off)")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = build_config(args.width, args.layers)
    print(f"model: {cfg.name}  ({cfg.param_count()/1e6:.1f}M params)")
    tcfg = TrainConfig(
        microbatch_size=max(1, args.batch // 2), dtype="float32",
        optimizer=OptimizerConfig(lr=3e-3, warmup_steps=20,
                                  total_steps=args.steps, weight_decay=0.01),
        log_every=10, checkpoint_every=args.checkpoint_every, keep_checkpoints=2)
    injector = FailureInjector({args.fail_at: ["host1"]} if args.fail_at else {})

    before = ops.LAUNCHES.snapshot()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(cfg, tcfg, global_batch=args.batch, seq_len=args.seq,
                          checkpoint_dir=ckpt_dir, impl=Impl(),
                          workers=[f"host{i}" for i in range(4)],
                          injector=injector, device=device)
        report = trainer.run(args.steps)
        final = trainer.ckpt.latest_step()

    first = np.mean(report.losses[:10])
    last = np.mean(report.losses[-10:])
    print(f"\nsteps run          : {report.steps_run}")
    print(f"restarts           : {report.restarts}")
    print(f"stragglers flagged : {report.stragglers}")
    print(f"loss               : {first:.4f} → {last:.4f} "
          f"({'IMPROVED' if last < first else 'NO IMPROVEMENT'})")
    for e in report.events:
        print("event:", e)
    check(all(np.isfinite(report.losses)), "non-finite loss")
    check(last < first, "training failed to reduce the loss")
    check(final == args.steps, f"last checkpoint at step {final}")
    if args.fail_at and args.fail_at < args.steps:
        resumed = args.fail_at - args.fail_at % args.checkpoint_every
        check(report.restarts == 1, f"{report.restarts} restarts")
        check(report.steps_run == args.steps + args.fail_at - resumed,
              f"{report.steps_run} steps run after a restart at "
              f"{args.fail_at} from step {resumed}")
    if device.type == "cuda":
        n = {k: v - before[k] for k, v in ops.LAUNCHES.snapshot().items()}
        micro = args.batch // tcfg.microbatch_size
        want = report.steps_run * micro * cfg.num_layers
        print(f"kernel launches: flash {n['flash_attention']}, "
              f"flash backward {n['flash_attention_bwd']}")
        check(n["flash_attention"] == want and n["flash_attention_bwd"] == want,
              f"flash launches {n}, want {want} each")
    print("train_e2e OK")


if __name__ == "__main__":
    main()
