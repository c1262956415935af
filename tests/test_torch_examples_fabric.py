"""The port's fabric example (``repro_torch.examples.fabric_parallel_demo``)
on the CPU: one world of four gloo ranks runs SP ring attention, the
expert-parallel MoE, the GPipe pipeline and the compressed reduce, each
held by the example against its one-rank oracle (it raises otherwise);
here its printed results are read back, no kernel launches on the CPU,
and no rank, store file or segment is left behind. The reference runs
the same four patterns on eight XLA host devices; the port's fabric is
held to the reference's functions in ``test_torch_fabric*.py``."""
import contextlib
import io
import multiprocessing
import re

import pytest

import torch_proc_handlers as H
from repro_torch.examples import fabric_parallel_demo as demo

pytestmark = pytest.mark.proc


@pytest.fixture(scope="module")
def run():
    buf = io.StringIO()
    with H.bounded(240), contextlib.redirect_stdout(buf):
        launches = demo.main(["--device", "cpu"])
    yield buf.getvalue(), launches
    H.proc_hygiene(__name__)


def test_fabric_demo_runs_every_pattern(run):
    out, _ = run
    for head in ("1. SP ring attention", "2. EP MoE dispatch", "3. PP GPipe",
                 "4. DP int8+EF reduce", "fabric_parallel_demo OK"):
        assert head in out, head
    assert out.count("guard ok=1") == 2


def test_fabric_demo_errors_within_its_bounds(run):
    out, _ = run
    errs = [float(x) for x in re.findall(r"max\|Δ\| vs [a-z ]+= ([0-9.e+-]+)", out)]
    assert len(errs) == 4
    assert max(errs[:3]) <= demo.TOL
    steps = float(re.search(r"\(([0-9.]+) int8 steps", out).group(1))
    assert steps <= 0.5 + 1e-3


def test_fabric_demo_launches_nothing_on_the_cpu_and_leaves_no_rank(run):
    _, launches = run
    assert launches and not any(launches.values())
    assert multiprocessing.active_children() == []
