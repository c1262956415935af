#!/usr/bin/env python3
"""Where a cell's host and device time goes, by the program's own spans.

Runs one cell as ``run.py --trace 1`` does, and after its profiled plans a
third: ``profile_warmup`` unrecorded steps (serve: ``SETTLE_TICKS`` more),
then ``profile_ticks`` (serve) or ``profile_steps`` (train) recorded with
the device's activity alone and the port's span recorder
(``repro_torch.tracing``) armed from the first recorded step to the last
(``harness/spans.py``); serve awaits the calls begun in it before any
plan is reduced. Then the recorder's cost:
``--blocks`` blocks of 64 ticks or of 2 train steps, alternately disarmed
and armed, each timed on the host's clock.

    python3 perfbench/span_trace.py --workload grok-1-314b.serve \
        --seed 7 --seconds 20 [--blocks 12] [--out FILE]

Prints the cell's result line, then one JSON line: ``spans`` (the third
plan's reduction: counts, host seconds, device seconds and launches and
idle seconds by span, the gateway calls' means, and the spans'
``metrics``) and ``on_cost`` (the blocks, and ``span``: one empty span's
host time off and armed). The benchmark's own runs (``run.py``) never arm
the recorder.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMED = "spans"                 # the third plan's marker in a serve plan list
SERVE_BLOCK_TICKS = 64
# unrecorded ticks before the armed plan beyond ``profile_warmup``: the
# queue's wait then holds no tick of the host-operator plan before it,
# which slows the engine
SETTLE_TICKS = 96
TRAIN_BLOCK_STEPS = 2


class _ServeBlocks:
    """On the engine's thread: ``n`` blocks of ``per`` ticks, alternately
    disarmed and armed, each block's host time kept."""

    def __init__(self, engine, n: int, per: int):
        from repro_torch import tracing
        self.tracing, self.engine, self.n, self.per = tracing, engine, n, per
        self.inner = engine.tick
        self.k, self.t, self.blocks = 0, None, []
        self.done = threading.Event()
        engine.tick = self.tick

    def tick(self):
        if self.k % self.per == 0:
            now = time.perf_counter()
            if self.t is not None:
                self.blocks.append(now - self.t)
            self.tracing.disarm()
            self.tracing.drain()
            b = self.k // self.per
            if b == self.n:
                self.engine.tick = self.inner
                self.done.set()
                return self.inner()
            if b % 2:
                self.tracing.arm()
            self.t = time.perf_counter()
        self.k += 1
        return self.inner()


@contextlib.contextmanager
def third_plan(cell, blocks: int, out: dict):
    """Add the armed plan and the cost blocks to ``cell``'s mode for the
    runs inside the block; ``out`` gets ``spans`` and ``on_cost``."""
    from perfbench.harness import bench, spans as spans_mod, trace as trace_mod
    mode = bench.mode_module(cell.mode, cell.root)
    real_scheduled = trace_mod.Scheduled

    def scheduled(warmup, active, host_ops, on_card):
        if host_ops == ARMED:
            return spans_mod.Armed(warmup, active, on_card, "engine.tick")
        return real_scheduled(warmup, active, host_ops, on_card)

    if cell.mode == "serve":
        real = mode.Probe.profile

        def profile(probe, plans, timeout):
            # Probe.profile with the armed plan last and, before any
            # reduction (whose host work slows the engine), the calls that
            # began in it awaited
            mix = cell.traffic
            probe._plans = list(plans) + [(mix["profile_warmup"] + SETTLE_TICKS,
                                           mix["profile_ticks"], ARMED)]
            if not probe._prof_done.wait(timeout):
                raise RuntimeError(f"the engine did not finish its profiled ticks "
                                   f"in {timeout} s")
            probe._results[-1]["prof"].settle()
            res = []
            for r in probe._results:
                red = r.pop("prof").reduce()
                red.update(r)
                res.append(red)
            out["spans"] = res.pop()["spans"]
            if blocks:
                b = _ServeBlocks(probe.engine, blocks, SERVE_BLOCK_TICKS)
                if not b.done.wait(timeout):
                    raise RuntimeError("the engine did not finish its cost blocks")
                out["on_cost"] = spans_mod.on_cost(b.blocks)
            return res

        trace_mod.Scheduled, mode.Probe.profile = scheduled, profile
        try:
            yield
        finally:
            trace_mod.Scheduled, mode.Probe.profile = real_scheduled, real
        return

    real = mode._profile

    def _profile(step, params, opt, batches, first, warmup, n, ops, on_card):
        red = real(step, params, opt, batches, first, warmup, n, ops, on_card)
        k = first + warmup + n
        prof = spans_mod.Armed(warmup, n, on_card, "train_step.forward")
        while True:
            params, opt, _ = step(params, opt, batches[k % len(batches)])
            k += 1
            if prof.after_step():
                break
        out["spans"] = prof.reduce()["spans"]
        if blocks:
            out["on_cost"] = spans_mod.on_cost(_train_blocks(
                step, params, opt, batches, k, blocks, on_card))
        return red

    mode._profile = _profile
    try:
        yield
    finally:
        mode._profile = real


def _train_blocks(step, params, opt, batches, k: int, n: int, on_card) -> list:
    import torch
    from repro_torch import tracing
    out = []
    for b in range(n):
        if b % 2:
            tracing.arm()
        t = time.perf_counter()
        for _ in range(TRAIN_BLOCK_STEPS):
            params, opt, _ = step(params, opt, batches[k % len(batches)])
            k += 1
        if on_card:
            torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
        tracing.disarm()
        tracing.drain()
    return out


def run(cell, seed: int, seconds: float, device, t_start: float, blocks: int):
    """→ (the result line, the outcome, {"spans", "on_cost"})."""
    from perfbench.harness import spans as spans_mod
    from perfbench.harness.cell import run_cell
    from repro_torch import tracing
    extra: dict = {}
    with third_plan(cell, blocks, extra):
        text, _, out = run_cell(cell, seed, seconds, True, device, t_start)
    tracing.drain()             # what the cost blocks' last calls left
    if "on_cost" in extra:      # with no other thread left to record spans
        extra["on_cost"]["span"] = spans_mod.span_cost_us()
    return text, out, extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench.run import prepare
    prepare()
    import torch
    from perfbench.harness import bench
    from perfbench.harness import line as line_mod
    from repro_torch.device import resolve
    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 3
    text, out, extra = run(cell, args.seed, args.seconds, resolve("cuda"), T_START,
                           args.blocks)
    doc = {"workload": args.workload, "seed": args.seed,
           "card": line_mod.card_info(cell.chips), **extra}
    print(text, flush=True)
    print(json.dumps(doc), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
