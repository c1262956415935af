"""On the card, at each cell's own size: a sound run is correct, and the
control (the plain reference in float8 in the program's place) fails one
of the cell's numbers. Skips where CUDA is absent.

    python3 -m pytest -q perfbench/tests -m card
"""
import pytest

from perfbench.harness import bench
from perfbench.harness.cell import run_cell


@pytest.fixture
def card():
    import gc

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from repro_torch.device import resolve
    yield resolve("cuda")
    gc.collect()                        # one cell's state before the next's
    torch.cuda.empty_cache()


def _control_readings(out):
    ctl = out.control
    return ctl["control"] if "control" in ctl else ctl["fp8"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["grok-1-314b.serve", "qwen3-14b.train",
                                      "qwen3-14b.train-long"])
def test_control_fails_where_the_program_passes(card, workload):
    cell = bench.load_cell(workload)
    _, checks, out = run_cell(cell, 2**31 + 77, 5.0, False, card, 0.0, calibrate=True)
    assert all(c["ok"] for c in checks.values()), checks
    ctl = _control_readings(out)
    assert any(ctl[name] > limit for name, limit in cell.limits.items()), ctl
