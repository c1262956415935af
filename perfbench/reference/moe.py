"""The plain reference of the sparse-expert family (grok-1-314b as the
port runs it): the dense family's attention, and in place of its MLP a
router and E gated SiLU experts. Each token goes to its top-k experts by
the router's softmax (ties to the lower expert), weighted by those k
probabilities renormalised to sum to 1; no token is dropped, as no decode
step drops one (the capacity of a decode step covers every token).

Departures from xAI's published Grok-1, which the port shares: no
attention-logit soft cap, no embedding or output multipliers, and one
RMS norm before each sub-block in place of Grok's norms around it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import common
from perfbench.reference.common import linear


def leaf_specs(cfg: dict) -> list:
    """The attention tree and ``blocks.ffn`` {router (L, D, E), gate, up
    (L, E, D, F), down (L, E, F, D)}."""
    L, D, Fd = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    E = cfg["num_local_experts"]
    return common.attn_leaf_specs(cfg) + [
        (("blocks", "ffn", "router"), (L, D, E), D ** -0.5, 0.0),
        (("blocks", "ffn", "gate"), (L, E, D, Fd), D ** -0.5, 0.0),
        (("blocks", "ffn", "up"), (L, E, D, Fd), D ** -0.5, 0.0),
        (("blocks", "ffn", "down"), (L, E, Fd, D), Fd ** -0.5, 0.0)]


def make_params(cfg: dict, seed: int, dtype, device) -> dict:
    return common.make_tree(leaf_specs(cfg), seed, dtype, device)


def route(cfg: dict, p: dict, h, precision: str, margins: list | None = None):
    """→ (top experts (T, k), their renormalised weights (T, k)). With
    ``margins``, appends each token's router margin: how far the k-th
    expert's router logit lies above the next one's (T,)."""
    k = cfg["num_experts_per_tok"]
    z = linear(h, p["ffn"]["router"], precision)
    probs = torch.softmax(z, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    if margins is not None:
        zs = torch.sort(z, dim=-1, descending=True).values
        margins.append(zs[:, k - 1] - zs[:, k])
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return top_e, top_p / top_p.sum(-1, keepdim=True)


def ffn(cfg: dict, p: dict, h, precision: str, margins: list | None = None):
    f = p["ffn"]
    top_e, top_w = route(cfg, p, h, precision, margins)
    y = torch.zeros_like(h)
    for e in range(cfg["num_local_experts"]):
        hit = top_e == e                                    # (T, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        he = h[rows]
        a = F.silu(linear(he, f["gate"][e], precision)) * linear(he, f["up"][e], precision)
        w = (top_w * hit)[rows].sum(-1, keepdim=True)
        y = y.index_add(0, rows, w * linear(a, f["down"][e], precision))
    return y


def logits(cfg: dict, params: dict, seqs, starts, precision: str = "f32",
           margins: list | None = None):
    """As ``common.logits_of_sequences``. With ``margins``, appends for
    each sequence the router margin of its positions from ``starts[i]`` on,
    the least over the layers: where it is within rounding of 0, a
    lower-precision router may pick another expert."""
    per_layer: list = []
    out = common.logits_of_sequences(
        cfg, params, seqs, starts,
        lambda c, p, h, prec: ffn(c, p, h, prec, per_layer), precision)
    if margins is not None:
        least = torch.stack(per_layer).amin(0).split([s.shape[0] for s in seqs])
        margins.extend(m[st:] for m, st in zip(least, starts))
    return out


def row_loss(cfg: dict, params: dict, tokens, precision: str = "f32"):
    raise NotImplementedError("no benchmark cell trains the sparse-expert family")
