"""The model's counts: a family's own where its reference defines them,
the yardstick's arithmetic elsewhere, and the serving readers' per-slot
keys giving today's sums bit for bit for the families that count
attention linearly."""
import copy
import random
import shutil

import pytest

from perfbench.harness import bench, costs

WINDOWED = '''"""The dense family's maths, counted as a window of 16 keys."""
from pathlib import Path

from perfbench.harness import bench, costs

_dense = bench.reference_module("dense", Path(__file__).resolve().parents[2])
leaf_specs, make_params, logits, row_loss = (_dense.leaf_specs, _dense.make_params,
                                             _dense.logits, _dense.row_loss)


def attn_flops_token(cfg, kv_len):
    return costs.attn_flops_token.__wrapped__(cfg, min(kv_len, 16))


def params_no_embed(cfg, active=True):
    return 1000
'''


@pytest.fixture
def windowed(tmp_path):
    """A checkout's copy with a family ``windowed`` beside the others, and
    the qwen3-14b file under that family, read from the copy."""
    shutil.copytree(bench.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "perfbench" / "reference" / "windowed.py").write_text(WINDOWED)
    return bench.load_config("perfbench/configs/qwen3-14b.json", tmp_path) | {
        "family": "windowed"}


def _records(config, seed):
    """A serving record of 40 ticks with per-slot keys, and the same
    record with each tick's sum alone."""
    rng = random.Random(seed)
    slots = [[rng.randint(1, 1024) for _ in range(rng.randint(1, 64))] for _ in range(40)]
    rec = {"mode": "serve", "config": config, "traffic": {"max_batch": 64}, "elem": 2,
           "window_s": 1.7, "live": [len(s) for s in slots],
           "kv": [sum(s) for s in slots], "kv_slots": slots}
    summed = {k: v for k, v in rec.items() if k != "kv_slots"}
    return rec, summed


@pytest.mark.parametrize("workload", ["grok-1-314b.serve", "qwen3-14b.train"])
@pytest.mark.parametrize("seed", [1, 2])
def test_per_slot_keys_give_the_sum_formula_bit_for_bit(workload, seed):
    cfg = bench.load_cell(workload).config
    rec, summed = _records(cfg, seed)
    # the readers' arithmetic before they took per-slot keys
    flops = (2.0 * costs.params_no_embed(cfg, True) * sum(rec["live"])
             + costs.attn_flops_token(cfg, 1) * sum(rec["kv"]))
    mfu = 100.0 * flops / rec["window_s"] / costs.PEAK_BF16
    bound = sum(costs.decode_tick_bound_s(cfg, 2, 64, live, kv)
                for live, kv in zip(rec["live"], rec["kv"]))
    roof = 100.0 * bound / rec["window_s"]
    for r in (rec, summed):
        assert bench.metric_reader("mfu.serve").read(r) == mfu
        assert bench.metric_reader("step_roofline.serve").read(r) == roof


def test_a_familys_counts_replace_the_arithmetic(windowed):
    cfg, plain = windowed, copy.deepcopy(windowed) | {"family": "dense"}
    assert costs.params_no_embed(cfg) == 1000
    assert costs.params_no_embed(plain) == costs.params_no_embed.__wrapped__(cfg) > 1000
    assert costs.attn_flops_token(cfg, 4096) == costs.attn_flops_token(plain, 16)
    assert costs.attn_flops_token(cfg, 8) == costs.attn_flops_token(plain, 8)
    # built from them: the decode tick's weights and the training step
    assert costs.decode_weight_bytes(cfg, 2, 64) == 2 * (1000 + 64 * 5120)
    assert costs.train_step_flops(cfg, 8, 2048) == \
        costs.train_step_flops(plain, 8, 2048) - 6.0 * (
            costs.params_no_embed(plain) - 1000) * 8 * 2048
    # the family's attention is not linear in the keys: per-slot keys count
    # it, each tick's sum alone (as one slot) cannot
    rec, summed = _records(cfg, 3)
    attn = sum(costs.attn_flops_token(plain, min(k, 16)) for t in rec["kv_slots"] for k in t)
    want = 100.0 * (2.0 * 1000 * sum(rec["live"]) + attn) / rec["window_s"] / costs.PEAK_BF16
    assert bench.metric_reader("mfu.serve").read(rec) == want
    assert bench.metric_reader("mfu.serve").read(summed) < want


def test_a_family_count_of_another_signature_is_refused(windowed, tmp_path):
    path = tmp_path / "perfbench" / "reference" / "windowed2.py"
    path.write_text(WINDOWED.replace("def params_no_embed(cfg, active=True)",
                                     "def params_no_embed(cfg)"))
    with pytest.raises(ValueError, match="params_no_embed"):
        costs.params_no_embed(windowed | {"family": "windowed2"})
