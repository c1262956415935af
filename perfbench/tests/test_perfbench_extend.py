"""A later change adds a configuration, a traffic mix, a mode or a
per-layer metric with new files and new ``BENCHMARK.json`` entries only:
here, in a copy of the checkout, each kind is added that way and run, and
no file the benchmark had is touched."""
import hashlib
import json
import shutil

import pytest
import torch

from perfbench.harness import bench
from perfbench.harness.cell import run_cell
from perfbench.tests.tiny import TINY, TINY_TRAFFIC, one_thread

NEW_METRIC = '''"""ticks_per_call.serve: engine ticks in the window over the calls
answered in it."""


def read(rec):
    if rec.get("mode") != "serve" or not rec["answered"]:
        return None
    return rec["ticks"] / rec["answered"]
'''

NEW_MODE = '''"""A mode that drives nothing but a matmul on the device, timed."""
import time

from perfbench.harness.cell import Outcome, check


def run(ctx):
    import torch
    n = ctx.cell.traffic["n"]
    a = torch.ones(n, n, device=ctx.device)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    k = 0
    while time.perf_counter() < t0 + ctx.seconds:
        b = a @ a
        k += 1
    err = float((b - n).abs().max())
    return Outcome(setup_s=setup_s, e2e={"matmuls_per_s": k / ctx.seconds},
                   attempted=k, failed=0, checks={"err": check(err, ctx.cell.limits["err"])},
                   rec={"mode": "matmul", "k": k})
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_mode_and_metric_are_files_only(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "perfbench")
    pb = tmp_path / "perfbench"

    # a configuration: the grok file's keys at a size the CPU holds
    cfg = json.loads((pb / "configs" / "grok-1-314b.json").read_text())
    cfg.update(TINY["moe"], name="tiny-moe", num_local_experts=8)
    (pb / "configs" / "tiny-moe.json").write_text(json.dumps(cfg))
    # a traffic mix for the serving mode, and one for a new mode
    mix = json.loads((pb / "traffic" / "serve.json").read_text())
    mix.update(TINY_TRAFFIC["serve"])
    (pb / "traffic" / "serve-tiny.json").write_text(json.dumps(mix))
    (pb / "traffic" / "matmul.json").write_text(json.dumps({"mode": "matmul", "n": 64}))
    (pb / "modes" / "matmul.py").write_text(NEW_MODE)
    (pb / "metrics" / "ticks_per_call.serve.py").write_text(NEW_METRIC)
    (pb / "limits" / "tiny-moe.serve-tiny.json").write_text(
        (pb / "limits" / "grok-1-314b.serve.json").read_text())
    (pb / "limits" / "tiny-moe.matmul.json").write_text(json.dumps({"err": 0}))

    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-moe", "source": "https://huggingface.co/xai-org/grok-1",
                           "file": "perfbench/configs/tiny-moe.json", "reduced": [],
                           "why": "a test's configuration"})
    doc["workloads"] += [
        {"name": "tiny-moe.serve-tiny", "config": "tiny-moe", "traffic": "serve-tiny",
         "chips": 1, "why": "a test's cell"},
        {"name": "tiny-moe.matmul", "config": "tiny-moe", "traffic": "matmul",
         "chips": 1, "why": "a test's cell of a new mode"}]
    doc["end_to_end"].append({"name": "matmuls_per_s", "unit": "1/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["tiny-moe.matmul"]})
    for m in doc["end_to_end"]:
        if m["name"] in ("output_tokens_per_s", "request_p95_ms"):
            m["workloads"].append("tiny-moe.serve-tiny")
    for m in doc["per_layer"]:
        if m["name"].endswith(".serve") or m["name"] in ("expert_ffn_roofline",
                                                         "decode_attention_roofline"):
            m["workloads"].append("tiny-moe.serve-tiny")
    doc["per_layer"].append({"name": "ticks_per_call.serve", "unit": "ticks",
                             "better": "lower", "source": "program_counter",
                             "layer": "engine", "moves": "request_p95_ms",
                             "workloads": ["tiny-moe.serve-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = bench.load_cell("tiny-moe.serve-tiny", root=tmp_path)
    with one_thread():
        text, _, _ = run_cell(cell, 9, 1.0, True, torch.device("cpu"), 0.0)
    line = json.loads(text)
    assert line["correct"] and line["metrics"]["ticks_per_call.serve"]["value"] > 0

    cell = bench.load_cell("tiny-moe.matmul", root=tmp_path)
    text, _, _ = run_cell(cell, 9, 0.2, False, torch.device("cpu"), 0.0)
    line = json.loads(text)
    assert line["correct"] and set(line["metrics"]) == {"matmuls_per_s", "setup_s"}

    after = _digests(pb)
    assert all(after[k] == v for k, v in before.items()), "an existing file changed"


def test_a_per_layer_metric_without_workloads_is_refused(monkeypatch):
    """Every per-layer metric lists the cells that report it."""
    doc = bench.load_json(bench.ROOT / "BENCHMARK.json")
    del doc["per_layer"][0]["workloads"]
    real = bench.load_json
    monkeypatch.setattr(bench, "load_json",
                        lambda p: doc if p.name == "BENCHMARK.json" else real(p))
    with pytest.raises(ValueError, match=doc["per_layer"][0]["name"]):
        bench.load_cell("grok-1-314b.serve")
