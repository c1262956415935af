"""The result's shape: the last line, the compared numbers, the refusals."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.harness import bench
from perfbench.harness import line as line_mod
from perfbench.harness.cell import run_cell
from perfbench.tests.tiny import one_thread, tiny_cell

ROOT = str(bench.ROOT)
CHECKS = {"rms_err_p50": {"value": 0.03, "limit": 0.1, "ok": True}}


def test_result_line_keys_in_order_checks_last():
    text = line_mod.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"setup_s": {"value": 1.5, "unit": "s"}},
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                "memory_peak_bytes": 7},
        checks=CHECKS, breakdown={"device_ops": [["k", 0.1]], "idle_gaps": []})
    doc = json.loads(text)
    assert list(doc) == ["correct", "attempted", "failed", "metrics", "device",
                         "breakdown", "checks"]
    assert doc["checks"] == {"rms_err_p50": {"value": 0.03, "limit": 0.1}}


def test_emit_prints_checks_last_on_stderr_and_the_line_last(capsys):
    line_mod.emit('{"correct": true}', CHECKS)
    out, err = capsys.readouterr()
    assert out.splitlines()[-1] == '{"correct": true}'
    assert err.splitlines()[-1].startswith("check rms_err_p50: 0.03 (limit 0.1")


def test_forbidden_modules_compares_whole_top_level_names():
    assert line_mod.forbidden_modules(["repro_torch", "repro_torch.core", "numpy"]) == []
    assert line_mod.forbidden_modules(["repro.core.gateway", "jaxlib.xla"]) == \
        ["jaxlib", "repro"]
    assert line_mod.forbidden_modules(["jax", "flax.linen", "jaxtyping"]) == ["flax", "jax"]


@pytest.mark.parametrize("workload,trace", [("grok-1-314b.serve", 0),
                                            ("grok-1-314b.serve", 1),
                                            ("qwen3-14b.train", 1)])
def test_a_run_prints_the_cells_metrics(workload, trace):
    """A whole run at the CPU's size: every key of the line, the cell's
    end-to-end metrics with their units (or, traced, only its per-layer
    ones), each compared number beside its limit."""
    cell = tiny_cell(workload)
    with one_thread():
        text, checks, _ = run_cell(cell, 2**31 + 17, 1.0, bool(trace),
                                   torch.device("cpu"), 0.0)
    doc = json.loads(text)
    assert set(doc) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(doc)[-1] == "checks" and doc["attempted"] > 0
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(doc["metrics"]) <= names and doc["metrics"]
    if not trace:
        assert set(doc["metrics"]) == names
    for k, v in doc["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float)
    assert set(doc["checks"]) == set(checks) >= set(cell.limits)
    if trace:
        assert {"busy_s", "window_s"} <= set(doc["device"]) and "breakdown" in doc


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA: exit non-zero, print no result. The same in a directory that
    holds only BENCHMARK.json and the benchmark's folder."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    args = ["--workload", "grok-1-314b.serve", "--seed", "3", "--seconds", "1"]
    p = subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout == ""
