"""Cells at a size the CPU test run can hold: the cells' own traffic
shapes cut down, and tiny configurations of each family."""
from __future__ import annotations

import contextlib
import copy

from perfbench.harness import bench

TINY = {
    "moe": {"hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
            "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 256},
    "dense": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
              "vocab_size": 256},
}

TINY_TRAFFIC = {
    "serve": {"callers": 6, "max_batch": 4, "max_seq": 64, "block": 8, "pool": 512,
              "prompt_tokens": {"dist": "exponential", "mean": 5, "min": 1, "max": 16},
              "max_new_tokens": {"dist": "exponential", "mean": 4, "min": 1, "max": 8},
              "warmup_requests": 8, "check_from": 14, "check_span": 16,
              "check_requests": 3, "check_window": 3, "profile_warmup": 2,
              "profile_ticks": 8, "profile_ops_ticks": 4},
    "train": {"global_batch": 4, "seq_len": 32, "micro": 2, "batches": 6,
              "profile_steps": 1},
}

# At this width a leaf's weight decay is a small part of its change beside
# the round-off of a bf16 step; ten times the cells' decay makes it plain.
TINY_OPTIMIZER = {"weight_decay": 1.0}


def tiny_cell(workload: str, limits: dict | None = None) -> bench.Cell:
    """The benchmark's cell ``workload`` with its configuration and traffic
    cut to the CPU's size (and ``limits`` in place of its own, if given)."""
    cell = copy.deepcopy(bench.load_cell(workload))
    cell.config.update(TINY[cell.config["family"]])
    cell.traffic.update(TINY_TRAFFIC[cell.mode])
    if cell.mode == "train":
        cell.traffic["optimizer"] = {**cell.traffic["optimizer"], **TINY_OPTIMIZER}
    if cell.mode == "train" and cell.traffic.get("remat"):
        cell.traffic.update(global_batch=2, micro=1, seq_len=64)
    if limits is not None:
        cell.limits = dict(limits)
    return cell


@contextlib.contextmanager
def one_thread():
    """Torch's CPU kernels on one thread while a tiny cell runs: the test
    run has several workers on the machine's cores, and a tiny run's many
    small operators only lose to oversubscribed thread pools."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
