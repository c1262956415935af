"""A later change adds a configuration, a traffic mix, a mode, a
per-layer metric or a new architecture (its reference and its model
counts) with new files and new ``BENCHMARK.json`` entries only:
here, in a copy of the checkout, each kind is added that way and run, and
no file the benchmark had is touched."""
import hashlib
import json
import shutil

import pytest
import torch

from perfbench.harness import bench, costs
from perfbench.harness.cell import run_cell
from perfbench.harness.model import port_config
from perfbench.tests.tiny import TINY, TINY_OPTIMIZER, TINY_TRAFFIC, one_thread

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


def _checkout(root):
    """A copy of the checkout's benchmark in ``root`` → its ``perfbench``
    folder and each file's digest."""
    shutil.copy(bench.ROOT / "BENCHMARK.json", root)
    shutil.copytree(bench.PERFBENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root / "perfbench", _digests(root / "perfbench")


def test_new_config_traffic_mode_and_metric_are_files_only(tmp_path):
    pb, before = _checkout(tmp_path)

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


NEW_FAMILY = '''"""A new architecture's reference: the dense family's maths, and model
counts of its own, read off its parameter leaves (each call noted in
``CALLS``)."""
import math
from pathlib import Path

from perfbench.harness import bench

_dense = bench.reference_module("dense", Path(__file__).resolve().parents[2])
leaf_specs, make_params, logits, row_loss = (_dense.leaf_specs, _dense.make_params,
                                             _dense.logits, _dense.row_loss)
CALLS = []


def _shape(cfg, path):
    return next(shape for p, shape, _, _ in leaf_specs(cfg) if p == path)


def params_no_embed(cfg, active=True):
    CALLS.append("params_no_embed")
    return sum(math.prod(shape) for path, shape, _, _ in leaf_specs(cfg)
               if path != ("embed", "tok"))


def attn_flops_token(cfg, kv_len):
    CALLS.append("attn_flops_token")
    L, _, H, Dh = _shape(cfg, ("blocks", "attn", "wq"))
    return 4.0 * L * H * Dh * kv_len
'''


def test_new_architecture_is_files_only(tmp_path):
    """A configuration whose family names a new reference, which brings its
    own model counts, and whose ``"port"`` object names the port's family:
    its serving and training cells run and are correct, and the model
    step's shares read the family's counts."""
    pb, before = _checkout(tmp_path)
    (pb / "reference" / "newarch.py").write_text(NEW_FAMILY)
    cfg = json.loads((pb / "configs" / "qwen3-14b.json").read_text())
    cfg.update(TINY["dense"], name="tiny-newarch", family="newarch",
               dtype="bfloat16", port={"family": "dense"})
    (pb / "configs" / "tiny-newarch.json").write_text(json.dumps(cfg))
    for mode, cell in (("serve", "grok-1-314b.serve"), ("train", "qwen3-14b.train")):
        mix = json.loads((pb / "traffic" / f"{mode}.json").read_text())
        mix.update(TINY_TRAFFIC[mode])
        if mode == "train":
            mix["optimizer"] = {**mix["optimizer"], **TINY_OPTIMIZER}
        (pb / "traffic" / f"{mode}-tiny.json").write_text(json.dumps(mix))
        limits = json.loads((pb / "limits" / f"{cell}.json").read_text())
        if mode == "train":     # this size's bf16 loss reads 0.7-2.9e-4 over seeds
            limits["loss_rel"] = 1e-3
        (pb / "limits" / f"tiny-newarch.{mode}-tiny.json").write_text(json.dumps(limits))

    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny-newarch",
                           "source": "https://huggingface.co/Qwen/Qwen3-14B",
                           "file": "perfbench/configs/tiny-newarch.json", "reduced": [],
                           "why": "a test's new architecture"})
    cells = {"serve": "tiny-newarch.serve-tiny", "train": "tiny-newarch.train-tiny"}
    doc["workloads"] += [{"name": name, "config": "tiny-newarch", "traffic": f"{mode}-tiny",
                          "chips": 1, "why": "a test's cell"} for mode, name in cells.items()]
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m and m["name"] in ("request_p95_ms", "mfu.serve",
                                              "step_roofline.serve"):
            m["workloads"].append(cells["serve"])
        if "workloads" in m and m["name"] in ("train_tokens_per_s", "mfu.train"):
            m["workloads"].append(cells["train"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    fam = bench.reference_module("newarch", tmp_path)
    for mode, name in cells.items():
        cell = bench.load_cell(name, root=tmp_path)
        assert port_config(cell.config).family == "dense"
        fam.CALLS.clear()
        with one_thread():
            text, _, out = run_cell(cell, 2**31 + 33, 1.0, True, torch.device("cpu"), 0.0)
        line = json.loads(text)
        assert line["correct"], line["checks"]
        cfg, rec = cell.config, out.rec
        assert costs.params_no_embed(cfg) == fam.params_no_embed(cfg)
        assert costs.params_no_embed(cfg) == costs.params_no_embed.__wrapped__(cfg)
        if mode == "serve":
            assert {"params_no_embed", "attn_flops_token"} <= set(fam.CALLS)
            attn = sum(fam.attn_flops_token(cfg, k) for t in rec["kv_slots"] for k in t)
            flops = 2.0 * fam.params_no_embed(cfg) * sum(rec["live"]) + attn
            assert line["metrics"]["mfu.serve"]["value"] == \
                100.0 * flops / rec["window_s"] / costs.PEAK_BF16
            assert "step_roofline.serve" in line["metrics"]
        else:
            assert "params_no_embed" in fam.CALLS
            assert line["metrics"]["mfu.train"]["value"] > 0

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
