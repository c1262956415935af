"""One run of one cell: the mode drives the program, the readers reduce
what it recorded, and the result is judged and printed."""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, Optional

from perfbench.harness import bench
from perfbench.harness import line as line_mod


@dataclass
class Context:
    """What a mode is given."""
    cell: bench.Cell
    seed: int
    seconds: float
    trace: bool
    device: object                      # torch.device
    t_start: float                      # host clock at process start
    calibrate: bool = False             # also read the control (lower precision)


@dataclass
class Outcome:
    """What a mode gives back."""
    setup_s: float
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, dict]             # name → {"value", "limit", "ok"}
    rec: dict                           # what the per-layer readers read
    peak_bytes: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    control: Dict[str, float] = field(default_factory=dict)


def check(value: float, limit: float) -> dict:
    """A compared number: at or under its limit passes."""
    return {"value": value, "limit": limit, "ok": bool(value <= limit)}


def metrics_of(cell: bench.Cell, out: Outcome, trace: bool) -> Dict[str, dict]:
    """With ``trace`` the cell's per-layer metrics (those whose reader finds
    something), else its end-to-end metrics."""
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = out.setup_s if m["name"] == "setup_s" else out.e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        return metrics
    for m in cell.per_layer:
        v = bench.metric_reader(m["name"], cell.root).read(out.rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def run_cell(cell: bench.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, calibrate: bool = False):
    """Run the cell once → (result line, checks, outcome)."""
    ctx = Context(cell, seed, seconds, trace, device, t_start, calibrate)
    out = bench.mode_module(cell.mode, cell.root).run(ctx)
    dev = {"platform": "cpu", "kind": "cpu", "count": cell.chips,
           "memory_peak_bytes": int(out.peak_bytes)}
    if getattr(device, "type", "cpu") == "cuda":
        dev = {**line_mod.card_info(cell.chips), "memory_peak_bytes": int(out.peak_bytes)}
    if trace:
        dev["busy_s"] = out.busy_s
        dev["window_s"] = out.window_s
    correct = all(c["ok"] for c in out.checks.values())
    text = line_mod.result_line(
        correct=correct, attempted=out.attempted, failed=out.failed,
        metrics=metrics_of(cell, out, trace), device=dev, checks=out.checks,
        breakdown=out.breakdown if trace else None)
    return text, out.checks, out


def main_run(args, t_start: float) -> int:
    """The command's body once the card is known to be there."""
    import torch
    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    from repro_torch.device import resolve
    text, checks, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                               resolve("cuda"), t_start)
    found = line_mod.forbidden_modules()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 4
    line_mod.emit(text, checks)
    return 0
