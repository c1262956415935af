"""The yardstick: the H100's peaks, and the operations and bytes of the
model and of each kernel of the path, from shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), which
assume the card's full 700 W: every run states the card's power limit
beside its shares. Kernel costs count each input byte read once and each
output byte written once, whatever a kernel reads again; operations are
those of the call's shapes (frozen copies of the port's ``cost``
functions, kept here so the program cannot change its own yardstick).

A configuration is its file's dict with the published key names
(``hidden_size``, ``num_attention_heads``, ...).

The model's counts (``params_no_embed``, ``attn_flops_token``,
``kv_row_bytes``, ``train_step_flops``, and ``decode_weight_bytes`` and
``decode_tick_bound_s``, built from them) are the family's where the
configuration's ``reference/<family>.py`` defines a function of the same
name and signature: a family that is not attention and a GLU FFN in every
layer counts its own work there, under ``perfbench/`` as the rest of the
yardstick. Elsewhere they are the arithmetic below, which stays reachable
as ``<count>.__wrapped__`` for a family's count to build on.
"""
from __future__ import annotations

import functools
import inspect
import numbers

from perfbench.harness import bench
from perfbench.harness.model import ROOT_KEY

PEAK_BF16 = 989e12          # FLOP/s, tensor cores
HBM_BW = 3.35e12            # bytes/s


@functools.lru_cache(maxsize=None)
def _own(root: str, family: str, fn):
    """The family's function of ``fn``'s name in ``<root>/perfbench/
    reference/<family>.py``, or None. Raises ValueError where its
    signature is not ``fn``'s."""
    own = getattr(bench.reference_module(family, root), fn.__name__, None)
    if own is None:
        return None
    sig = [(p.name, p.kind, p.default) for p in inspect.signature(own).parameters.values()]
    want = [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]
    if sig != want:
        raise ValueError(f"reference/{family}.py: {fn.__name__}{inspect.signature(own)} "
                         f"is not {fn.__name__}{inspect.signature(fn)}")
    return own


def _model_count(fn):
    """``fn``, or the configuration's family's own function of its name."""
    @functools.wraps(fn)
    def count(cfg: dict, *args, **kw):
        own = _own(cfg.get(ROOT_KEY) or str(bench.ROOT), cfg["family"], fn) \
            if cfg.get("family") else None
        return (own or fn)(cfg, *args, **kw)
    return count


def dims(cfg: dict) -> dict:
    """The sizes the counts need, under short names."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"L": cfg["num_hidden_layers"], "D": D, "H": H,
            "Hkv": cfg["num_key_value_heads"],
            "Dh": cfg.get("head_dim") or D // H,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "E": cfg.get("num_local_experts", 0),
            "k": cfg.get("num_experts_per_tok", 0),
            "qk_norm": bool(cfg.get("qk_norm", False))}


def layer_params(cfg: dict, active: bool) -> int:
    """Parameters of one layer: attention, its norms, the FFN (an MoE
    layer's router and, with ``active``, only its top-k experts)."""
    d = dims(cfg)
    D, H, Hkv, Dh, F = d["D"], d["H"], d["Hkv"], d["Dh"], d["F"]
    n = 2 * D * H * Dh + 2 * D * Hkv * Dh + 2 * D
    if d["qk_norm"]:
        n += 2 * Dh
    if d["E"]:
        n += D * d["E"] + (d["k"] if active else d["E"]) * 3 * D * F
    else:
        n += 3 * D * F
    return n


@_model_count
def params_no_embed(cfg: dict, active: bool = True) -> int:
    """Parameters a token's forward multiplies by: every layer (active
    experts only, with ``active``), the final norm and the LM head; the
    input embedding is a lookup and is left out."""
    d = dims(cfg)
    return d["L"] * layer_params(cfg, active) + d["D"] + d["D"] * d["V"]


@_model_count
def attn_flops_token(cfg: dict, kv_len: int) -> float:
    """Attention FLOPs of one query over ``kv_len`` keys in every layer:
    4·H·Dh a key (scores and the weighted sum)."""
    d = dims(cfg)
    return 4.0 * d["H"] * d["Dh"] * kv_len * d["L"]


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


@_model_count
def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6·N·T (N without the input
    embedding, active experts only) and causal attention, three times its
    forward (4·H·Dh a pair)."""
    d = dims(cfg)
    return (6.0 * params_no_embed(cfg, active=True) * batch * seq
            + 12.0 * d["H"] * d["Dh"] * d["L"] * batch * causal_pairs(seq))


def bound_s(nbytes: float, flops: float, peak: float = PEAK_BF16) -> float:
    """The least time of a piece of work: bytes over HBM or operations over
    the peak, whichever is larger."""
    return max(nbytes / HBM_BW, flops / peak)


# -- the decode tick ---------------------------------------------------------

@_model_count
def decode_weight_bytes(cfg: dict, elem: int, batch: int) -> float:
    """Bytes of weights a decode tick reads once: every layer with all its
    experts (a tick of many tokens routes to every expert), the final norm
    and the head, and the embedding rows of the batch's tokens."""
    d = dims(cfg)
    return elem * (params_no_embed(cfg, active=False) + batch * d["D"])


@_model_count
def kv_row_bytes(cfg: dict, elem: int) -> float:
    """Bytes of one cached position's K and V in every layer."""
    d = dims(cfg)
    return 2.0 * d["Hkv"] * d["Dh"] * elem * d["L"]


@_model_count
def decode_tick_bound_s(cfg: dict, elem: int, batch: int, live: int,
                        kv_rows) -> float:
    """The tick's least time: weights read once and the live cache read
    once over HBM, or the model FLOPs of its ``live`` tokens over the bf16
    peak. ``kv_rows`` is the keys each live slot attends, a list (each
    slot's attention is ``attn_flops_token`` of its keys), or their sum
    (attention linear in the keys)."""
    if isinstance(kv_rows, numbers.Integral):
        rows, attn = kv_rows, attn_flops_token(cfg, 1) * kv_rows
    else:
        rows, attn = sum(kv_rows), sum(attn_flops_token(cfg, k) for k in kv_rows)
    nbytes = decode_weight_bytes(cfg, elem, batch) + rows * kv_row_bytes(cfg, elem)
    flops = 2.0 * params_no_embed(cfg, True) * live + attn
    return bound_s(nbytes, flops)


def tick_slots(rec: dict) -> list:
    """A serving record's keys a tick, one list a tick of one count a live
    slot (``kv_slots``); a record with each tick's sum alone (``kv``) gives
    that sum as one slot."""
    return rec.get("kv_slots") or [[k] for k in rec["kv"]]


def decode_attention_cost(cfg: dict, elem: int, batch: int, rows: int) -> dict:
    """One layer's decode-attention call over ``rows`` cached keys in all
    (summed over the batch): those rows of K and V and their positions read
    once, q read and the output written once."""
    d = dims(cfg)
    nbytes = (2 * rows * d["Hkv"] * d["Dh"] + 2 * batch * d["H"] * d["Dh"]) * elem \
        + 4 * rows + 4 * batch
    return {"flops": 4.0 * d["H"] * d["Dh"] * rows, "bytes": float(nbytes)}


def expert_bmm_cost(cfg: dict, elem: int, rows: int) -> dict:
    """One MoE layer's three expert ``bmm``s over ``rows`` rows an expert
    (gate, up: (E, R, D) @ (E, D, F); down: (E, R, F) @ (E, F, D)), each
    operand read once and each result written once."""
    d = dims(cfg)
    E, D, F = d["E"], d["D"], d["F"]
    per = E * (rows * D + D * F + rows * F)
    return {"flops": 3 * 2.0 * E * rows * D * F, "bytes": float(3 * per * elem)}


# -- flash attention in training ---------------------------------------------

def flash_fwd_cost(cfg: dict, elem: int, rows: int, seq: int) -> dict:
    """The forward kernel over ``rows`` sequences of ``seq`` (causal, with
    the log-sum-exp): 4·Dh·H a pair; q, k, v, the positions read once, the
    output and the log-sum-exp written once."""
    d = dims(cfg)
    q = rows * seq * d["H"] * d["Dh"]
    k = rows * seq * d["Hkv"] * d["Dh"]
    nbytes = (2 * q + 2 * k) * elem + 4 * 2 * rows * seq + 4 * rows * seq * d["H"]
    return {"flops": 4.0 * d["Dh"] * d["H"] * rows * causal_pairs(seq),
            "bytes": float(nbytes)}


def flash_bwd_cost(cfg: dict, elem: int, rows: int, seq: int) -> dict:
    """The backward kernels: 10·Dh·H a pair; q, k, v, the output, dO and
    the log-sum-exp read once, dQ, dK, dV written once, the positions."""
    d = dims(cfg)
    q = rows * seq * d["H"] * d["Dh"]
    k = rows * seq * d["Hkv"] * d["Dh"]
    nbytes = (4 * q + 4 * k) * elem + 4 * rows * seq * d["H"] + 4 * 2 * rows * seq
    return {"flops": 10.0 * d["Dh"] * d["H"] * rows * causal_pairs(seq),
            "bytes": float(nbytes)}
