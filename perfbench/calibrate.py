#!/usr/bin/env python3
"""Readings for the limits that decide ``correct``: runs a cell once a
seed, each in a process of its own, and prints one JSON line a run with
the program's compared numbers beside the control's (the plain reference
in float8 in the program's place) and, for training, beside the faults'
(half of each batch left out; the update without weight decay and the key
and value updates swapped, planted in the reference's result), the
metrics and the card. ``--control 0`` reads the program's numbers alone.

    python3 perfbench/calibrate.py --workload qwen3-14b.train \
        --seeds 11,12,13 --seconds 5 [--trace 1] [--control 1] [--out FILE] \
        [--rec FILE]

``--out`` also gets every checked position's readings (serving) and every
leaf's (training); ``--rec`` gets each run's whole record, what the
per-layer readers read, one JSON line a run, for reading it again with
other readers. Not part of a benchmark run: the runs of ``run.py``
never compute the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(args) -> dict:
    sys.path.insert(0, ROOT)
    from perfbench.run import prepare
    prepare()
    import torch
    from perfbench.harness import bench
    from perfbench.harness.cell import run_cell
    from repro_torch.device import resolve
    cell = bench.load_cell(args.workload)
    text, checks, out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                 resolve("cuda"), T_START, calibrate=bool(args.control))
    if args.rec:
        save_rec(args, out.rec)
    doc = json.loads(text)
    return {"workload": args.workload, "seed": args.seed, "trace": args.trace,
            "correct": doc["correct"], "metrics": doc["metrics"],
            "device": doc["device"], "breakdown": doc.get("breakdown"),
            "program": {k: v["value"] for k, v in checks.items()},
            "control": out.control,
            "rec": {k: v for k, v in out.rec.items()
                    if (isinstance(v, (int, float)) and not isinstance(v, bool))
                    or k == "setup_marks_s"},
            "setup_s": out.setup_s, "e2e": out.e2e,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def save_rec(args, rec: dict) -> None:
    with open(args.rec, "a") as f:
        f.write(json.dumps({"workload": args.workload, "seed": args.seed,
                            "rec": rec}, default=str) + "\n")


def brief(rec: dict) -> dict:
    """A run's record without its per-position and per-leaf readings,
    which go to ``--out`` alone."""
    ctl = rec.get("control")
    if not isinstance(ctl, dict):
        return rec
    ctl = {k: ({kk: vv for kk, vv in v.items() if kk != "positions"}
               if isinstance(v, dict) else v)
           for k, v in ctl.items() if k not in ("leaves", "positions")}
    return {**rec, "control": ctl}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default=None, help="comma-separated")
    ap.add_argument("--seed", type=int, default=None, help="one run, in this process")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rec", default=None)
    args = ap.parse_args()
    if args.seed is not None:
        print("CALIBRATION " + json.dumps(one(args)), flush=True)
        return 0
    rc = 0
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--workload", args.workload, "--seed", str(seed),
                            "--seconds", str(args.seconds), "--trace", str(args.trace),
                            "--control", str(args.control)]
                           + (["--rec", os.path.abspath(args.rec)] if args.rec else []),
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("CALIBRATION ")]
        rec = json.loads(lines[-1][12:]) if lines else {
            "workload": args.workload, "seed": seed, "rc": p.returncode,
            "stderr": p.stderr[-3000:]}
        rec["wall_s"] = time.perf_counter() - t0
        rc |= p.returncode
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        print(json.dumps(brief(rec)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
