"""The plain reference of the dense decoder family (qwen3-14b): pre-norm
blocks of grouped-query attention (RoPE, optional per-head q/k RMS norms)
and a gated SiLU MLP, a final RMS norm and an untied LM head."""
from __future__ import annotations

import torch.nn.functional as F

from perfbench.reference import common
from perfbench.reference.common import linear


def leaf_specs(cfg: dict) -> list:
    """The attention tree and ``blocks.ffn`` {gate, up (L, D, F), down
    (L, F, D)}."""
    L, D, Fd = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    return common.attn_leaf_specs(cfg) + [
        (("blocks", "ffn", "gate"), (L, D, Fd), D ** -0.5, 0.0),
        (("blocks", "ffn", "up"), (L, D, Fd), D ** -0.5, 0.0),
        (("blocks", "ffn", "down"), (L, Fd, D), Fd ** -0.5, 0.0)]


def make_params(cfg: dict, seed: int, dtype, device) -> dict:
    return common.make_tree(leaf_specs(cfg), seed, dtype, device)


def ffn(cfg: dict, p: dict, h, precision: str):
    f = p["ffn"]
    a = F.silu(linear(h, f["gate"], precision)) * linear(h, f["up"], precision)
    return linear(a, f["down"], precision)


def logits(cfg: dict, params: dict, seqs, starts, precision: str = "f32",
           margins: list | None = None):
    """As ``common.logits_of_sequences``; ``margins`` is left empty, as a
    dense block has no router."""
    return common.logits_of_sequences(cfg, params, seqs, starts, ffn, precision)


def row_loss(cfg: dict, params: dict, tokens, precision: str = "f32"):
    return common.row_loss(cfg, params, tokens, ffn, precision)
