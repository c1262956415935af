#!/usr/bin/env python3
"""The spreads a cell's bounds are set from: runs ``run.py`` for each seed
of each set (the same seeds in every set, set after set, each run a
process of its own), then the traced runs, and prints for every
end-to-end metric each set's spread, the distance between the first and
third quartile (``statistics.quantiles(values, n=4)``) over the median.

    python3 perfbench/spread.py --workload grok-1-314b.serve \
        --seeds 11,12,13,14,15,16 --sets 2 --trace-seeds 21,22,23 \
        --seconds 51 --out sets.jsonl

Each run's record (its last line, exit code, wall time and the end of its
standard error) is appended to ``--out`` as it ends.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                        "--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True)
    rec = {"workload": workload, "seed": seed, "trace": trace, "rc": p.returncode,
           "wall_s": time.perf_counter() - t0, "stderr_tail": p.stderr[-2000:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["line"] = json.loads(lines[-1])
    return rec


def spread(values):
    """None for fewer than two values."""
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def without_farthest(values):
    if len(values) < 3:
        return values
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def report(records) -> dict:
    """Per metric: each set's spread, each set's spread without its run
    farthest from the median, and the widest spread of all runs."""
    sets = {}
    for r in records:
        if r["trace"] or "line" not in r:
            continue
        for name, m in r["line"]["metrics"].items():
            sets.setdefault(name, {}).setdefault(r["set"], []).append(m["value"])
    out = {}
    for name, by_set in sets.items():
        vals = [v for s in sorted(by_set) for v in by_set[s]]
        out[name] = {
            "medians": [statistics.median(by_set[s]) for s in sorted(by_set)],
            "spreads": [spread(by_set[s]) for s in sorted(by_set)],
            "spreads_without_farthest": [spread(without_farthest(by_set[s]))
                                         for s in sorted(by_set)],
            "spread_all": spread(vals)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    plan = [(k + 1, s, 0) for k in range(args.sets) for s in seeds]
    plan += [(0, int(s), 1) for s in args.trace_seeds.split(",") if s]
    records = []
    for set_no, seed, trace in plan:
        rec = run_one(args.workload, seed, args.seconds, trace)
        rec["set"] = set_no
        records.append(rec)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    print(json.dumps({"workload": args.workload, "spreads": report(records)}, indent=1))
    return 0 if all(r["rc"] == 0 for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
