"""Serving example: continuous batching over a fixed slot grid.

Submits a burst of requests with different prompt and generation lengths
and drains them through the port's batched decode engine (a reduced
configuration with its heads widened to the kernels' smallest tiles,
``examples._common.kernel_tiled``), printing each
request's latency and the aggregate throughput. The SSM architecture
(mamba2 family) is the default, to show O(1) state serving; ``--arch``
picks a dense one (decode attention on the card). Then every request's
tokens are checked against the model's full-sequence forward over its
prompt and answer (the SSD scan, or flash attention, on the card): each
served token is that forward's greedy choice wherever the choice is not
a float tie.

    python -m repro_torch.examples.serve_decode [--device cuda] [--arch A]
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.device import resolve
from repro_torch.examples._common import check, kernel_tiled, parser
from repro_torch.kernels import ops
from repro_torch.models import Impl, forward, init_params
from repro_torch.runtime import Request, ServingEngine

ARCHS = ["mamba2-1.3b", "llama3.2-1b", "olmo-1b", "smollm-360m", "qwen3-14b"]


TIE = 1e-3          # top-2 logit margin under which greedy choices may differ


def check_against_forward(cfg, params, done, device):
    """Each request's served tokens against one forward over prompt +
    answer → the number of positions compared."""
    compared = 0
    with torch.no_grad():
        for r in done:
            seq = r.prompt + r.generated[:-1]
            logits, _ = forward(cfg, params, {"tokens": torch.tensor(
                [seq], dtype=torch.int64, device=device)}, impl=Impl(),
                dtype=torch.float32)
            tail = logits[0, len(r.prompt) - 1:, :cfg.vocab_size].float()
            top2 = tail.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu().tolist()
            want = tail.argmax(-1).cpu().tolist()
            for t, (got, w, m) in enumerate(zip(r.generated, want, margin)):
                check(got == w or m < TIE,
                      f"request {r.rid} token {t}: served {got}, forward {w} "
                      f"(margin {m:.2e})")
                compared += 1
    return compared


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--arch", default="mamba2-1.3b", choices=ARCHS)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=4)
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = kernel_tiled(get_reduced(args.arch))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    eng = ServingEngine(cfg, params, max_batch=args.max_batch, max_seq=96,
                        impl=Impl(), dtype=torch.float32, device=device)

    before = ops.LAUNCHES.snapshot()
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = [(7 * i + j) % cfg.vocab_size for j in range(3 + i % 5)]
        eng.submit(Request(rid=i, prompt=prompt, max_new=6 + (i % 4)))
    done = eng.run_until_drained()
    wall = time.perf_counter() - t0

    total_new = sum(len(r.generated) for r in done)
    print(f"arch={cfg.name} slots={args.max_batch}")
    for r in sorted(done, key=lambda r: r.rid):
        lat = r.finished_at - r.submitted_at
        print(f"req {r.rid:2d}: prompt={len(r.prompt):2d} "
              f"generated={len(r.generated):2d} latency={lat*1e3:7.1f} ms "
              f"tokens={r.generated}")
    print(f"\n{len(done)} requests, {total_new} new tokens, "
          f"{eng.ticks} engine ticks, {wall:.2f}s wall "
          f"({total_new/wall:.1f} tok/s)")
    check(len(done) == args.requests, f"{len(done)} of {args.requests} drained")
    for r in done:
        check(len(r.generated) == 6 + r.rid % 4
              and all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.rid}: {r.generated}")
    n_tok = check_against_forward(cfg, params, done, device)
    print(f"served tokens agree with the full-sequence forward at {n_tok} "
          f"positions")
    if device.type == "cuda":
        n = {k: v - before[k] for k, v in ops.LAUNCHES.snapshot().items()}
        kernels = (("ssd_scan",) if cfg.family == "ssm"
                   else ("decode_attention", "flash_attention"))
        print("kernel launches: " + ", ".join(f"{k} {n[k]}" for k in kernels))
        check(all(n[k] > 0 for k in kernels), f"a kernel never launched: {n}")
    print("serve_decode OK")


if __name__ == "__main__":
    main()
