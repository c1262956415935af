#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload grok-1-314b.serve --seed 7 \
        --seconds 51 --trace 0

From the root of a checkout, on a machine with the card(s) the cell asks
for. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics (with a profiled sub-window after the measured one).
Exits non-zero, printing no result, when CUDA or enough cards are missing,
when the run loaded JAX or the JAX package, or when anything fails.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import faulthandler  # noqa: E402
import sys  # noqa: E402

WATCHDOG_S = 1150
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare() -> None:
    """The environment of a run: every cache it could write at a fixed
    place in the checkout, no Flax behind ``transformers``, and the port
    and the benchmark importable."""
    cache = os.path.join(ROOT, "build", "perfbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT, os.path.join(ROOT, "src")):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a run that hangs says where, and ends, well before any outer limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    prepare()
    from perfbench.harness.cell import main_run
    return main_run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
