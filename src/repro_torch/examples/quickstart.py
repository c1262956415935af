"""Quickstart: the whole system in a couple of minutes.

1. MPKLink (the paper): CA enrollment → protected channel → word-count
   round trip, and a frame forged under the wrong session seed refused.
2. The LM stack: a tiny llama-family model (reduced llama3.2-1b, its
   heads 64 wide: the flash kernel's smallest tile) trained a few steps by
   the port's ``Trainer`` (flash attention forward and backward on the
   card), then decoded greedily by ``decode_step`` (decode attention on
   the card).

    python -m repro_torch.examples.quickstart [--device cuda] [--steps 20]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import OptimizerConfig, TrainConfig, get_reduced
from repro_torch.core import framing
from repro_torch.core.transports import MPKLinkTransport
from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler
from repro_torch.device import resolve
from repro_torch.examples._common import check, kernel_tiled, parser
from repro_torch.kernels import ops
from repro_torch.models import Impl, decode_step, init_decode_state
from repro_torch.runtime import Trainer

DECODE_TOKENS = 8


def demo_mpklink(device):
    print("=== 1. MPKLink: protected shared-memory IPC (the paper) ===")
    tr = MPKLinkTransport(wordcount_handler, device=device)
    tr.start()
    try:
        count = parse_count(tr.request(make_text(10_000, seed=0)))
        print(f"word count over MPKLink channel: {count}  "
              f"(key syncs so far: {tr.sync_count})")
        check(count == 10_000, f"word count {count}")
        # the security envelope: a frame built under the wrong session seed
        # fails the receive-side guard
        frame = framing.build_frame(np.arange(8, dtype=np.int32),
                                    seed=tr.seed ^ 0xDEAD, seq=0, device=device)
        try:
            framing.parse_frame(frame, seed=tr.seed)
        except framing.FrameError as e:
            print(f"forged frame rejected: {e}")
        else:
            check(False, "a forged frame verified")
    finally:
        tr.close()


def demo_lm(device, steps: int):
    print("\n=== 2. LM stack: train a tiny model, then decode ===")
    cfg = kernel_tiled(get_reduced("llama3.2-1b"))
    tcfg = TrainConfig(microbatch_size=2, dtype="float32",
                       optimizer=OptimizerConfig(lr=2e-3, warmup_steps=5,
                                                 total_steps=100),
                       log_every=5)
    trainer = Trainer(cfg, tcfg, global_batch=4, seq_len=64, impl=Impl(),
                      device=device)
    before = ops.LAUNCHES.snapshot()
    _, state = trainer.restore_or_init()
    report = trainer.run(steps, state=state)
    print(f"loss: {report.losses[0]:.3f} → {report.losses[-1]:.3f}")
    check(report.steps_run == steps and all(np.isfinite(report.losses)),
          f"training: {report.steps_run} steps, losses {report.losses}")
    check(report.losses[-1] < report.losses[0], "the loss did not fall")

    params = state["params"]
    st = init_decode_state(cfg, 1, 32, dtype=torch.float32, device=device,
                           params=params)
    tok = torch.tensor([[1]], dtype=torch.int32, device=device)
    toks = []
    with torch.no_grad():
        for _ in range(DECODE_TOKENS):
            logits, st = decode_step(cfg, params, st, tok, impl=Impl(),
                                     dtype=torch.float32)
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            tok = logits[:, -1:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            toks.append(int(tok[0, 0]))
    print("greedy decode:", toks)
    check(all(0 <= t < cfg.vocab_size for t in toks), f"tokens {toks}")
    if torch.device(device).type == "cuda":
        n = {k: v - before[k] for k, v in ops.LAUNCHES.snapshot().items()}
        print(f"kernel launches: flash {n['flash_attention']}, flash backward "
              f"{n['flash_attention_bwd']}, decode attention {n['decode_attention']}")
        check(n["flash_attention"] > 0 and n["flash_attention_bwd"] > 0
              and n["decode_attention"] == DECODE_TOKENS * cfg.num_layers,
              f"kernel launches {n}")


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve(args.device)
    demo_mpklink(device)
    demo_lm(device, args.steps)
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
