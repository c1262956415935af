"""Whole-window arithmetic of the end-to-end metrics."""
from __future__ import annotations

import math
from typing import Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all
    ``values``: the smallest value with at least q% of them at or below
    it. Raises on no values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])


def in_window(records: Iterable[dict], t0: float, t1: float):
    """The call records that ended inside [t0, t1)."""
    return [r for r in records if t0 <= r["t_end"] < t1]


def serve_window(records: Sequence[dict], t0: float, t1: float) -> dict:
    """Over the calls that ended in [t0, t1): answered (verified, with
    every token asked for) and failed calls, generated tokens of the
    answered ones over the window, and the 95th percentile of every
    answered call's latency. A failed call counts as failed, never as a
    latency."""
    done = in_window(records, t0, t1)
    ok = [r for r in done if r["ok"]]
    window = t1 - t0
    return {"attempted": len(done), "failed": len(done) - len(ok),
            "answered": len(ok),
            "output_tokens": sum(r["n_out"] for r in ok),
            "output_tokens_per_s": sum(r["n_out"] for r in ok) / window,
            "request_p95_ms": percentile([1e3 * (r["t_end"] - r["t_start"])
                                          for r in ok], 95) if ok else None}


def train_rate(tokens_per_step: int, steps: int, t0: float, t_end: float) -> float:
    """Tokens of ``steps`` whole steps over the time from the window's
    start ``t0`` to the synchronised end of the last one."""
    return tokens_per_step * steps / (t_end - t0)
