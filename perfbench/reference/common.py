"""Plain PyTorch pieces the family references share: float32 arithmetic
with TF32 off, or, for the control, every linear layer's operands rounded
to float8 (one scale a tensor: e4m3 forward, e5m2 for the gradient
backward) before a float32 product.

Nothing here imports the program: the references take the benchmark's own
inputs (weights and tokens made from the seed) and work out everything
else again.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("f32", "fp8")


def exact_f32() -> None:
    """Full float32 products on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to a float8 format at one scale for the tensor (its
    largest magnitude maps to the format's largest finite value)."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _LinearFP8(torch.autograd.Function):
    """x @ w with float8 operands, as float8 training computes a linear
    layer: the forward's operands in e4m3, the backward's incoming
    gradient in e5m2, each product accumulated in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = round_fp8(x), round_fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = round_fp8(g, torch.float8_e5m2)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., K) @ w (K, N) in float32; under ``fp8`` the operands of the
    forward and of the backward are rounded to float8 first."""
    w = w.float()
    if precision == "fp8":
        return _LinearFP8.apply(x, w)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rms_norm(x: torch.Tensor, scale, eps: float) -> torch.Tensor:
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return y if scale is None else y * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, n, Dh) at positions ``pos`` (S,): the
    halves (x1, x2) turn by pos · theta^(-i / half)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = pos.float()[:, None] * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, q0: int):
    """Queries q (Sq, H, Dh) at positions q0.. over k, v (Skv, H, Dh),
    causal."""
    Sq, Skv = q.shape[0], k.shape[0]
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    qp = torch.arange(q0, q0 + Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None]
    s = s.masked_fill(kp > qp, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def causal_attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """Causal grouped-query attention of one sequence: q (S, H, Dh), k, v
    (S, Hkv, Dh); query head h reads key head h // (H / Hkv). Computed in
    blocks of ``block`` queries (each recomputed in the backward), so no
    (H, S, S) tensor is ever whole."""
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    outs = []
    for q0 in range(0, q.shape[0], block):
        qb = q[q0:q0 + block]
        kb, vb = k[:q0 + qb.shape[0]], v[:q0 + qb.shape[0]]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_block, qb, kb, vb, q0,
                                   use_reentrant=False))
        else:
            outs.append(_attend_block(qb, kb, vb, q0))
    return torch.cat(outs, dim=0)


def cross_entropy_sum(x, head, targets, precision: str, block: int = 1024):
    """Σ over positions of −log softmax(x @ head)[target], positions with
    target −1 left out; in blocks of ``block`` positions, each recomputed
    in the backward, so the (S, V) logits are never whole."""
    def piece(xb, tb):
        logits = linear(xb, head, precision)
        return F.cross_entropy(logits, tb, ignore_index=-1, reduction="sum")
    total = x.new_zeros(())
    for s0 in range(0, x.shape[0], block):
        xb, tb = x[s0:s0 + block], targets[s0:s0 + block]
        total = total + (checkpoint(piece, xb, tb, use_reentrant=False)
                         if torch.is_grad_enabled() else piece(xb, tb))
    return total


def attention_block(cfg: dict, p: dict, x, pos, precision: str):
    """The attention sub-block of one layer on one sequence x (S, D):
    pre-norm, projections, per-head q/k norms where the configuration has
    them, RoPE, causal attention, the output projection; → the residual's
    new value."""
    D = cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    h = rms_norm(x, p["ln1"]["scale"], eps)
    q = linear(h, p["attn"]["wq"].reshape(D, H * Dh), precision).view(-1, H, Dh)
    k = linear(h, p["attn"]["wk"].reshape(D, Hkv * Dh), precision).view(-1, Hkv, Dh)
    v = linear(h, p["attn"]["wv"].reshape(D, Hkv * Dh), precision).view(-1, Hkv, Dh)
    if cfg.get("qk_norm"):
        q = rms_norm(q, p["attn"]["q_norm"], eps)
        k = rms_norm(k, p["attn"]["k_norm"], eps)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    o = causal_attention(q, k, v)
    return x + linear(o.reshape(-1, H * Dh), p["attn"]["wo"].reshape(H * Dh, D),
                      precision)


def layer_view(stacked: dict, i: int) -> dict:
    """Layer i of a tree stacked on a leading L axis."""
    return {k: layer_view(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def walk(tree, prefix=()):
    """(path, leaf) of a nested dict, in sorted-key order at each level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw(shape, std: float, mean: float, seed: int, dtype, device):
    """One leaf of the benchmark's weights: N(mean, std²) drawn on
    ``device`` by a generator of its own seeded with ``seed``, in
    ``dtype``, in one call."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn(shape, generator=g, dtype=dtype, device=device)
    if std != 1.0:
        t.mul_(std)
    if mean:
        t.add_(mean)
    return t


# -- the decoder-only transformer every family here shares --------------------

def attn_leaf_specs(cfg: dict) -> list:
    """(path, shape, std, mean) of the embedding, the head, the norms and
    the attention weights, in the port's parameter tree: ``embed`` {tok
    (V, D), head (D, V)}, ``final_norm`` {scale}, ``blocks`` stacked on L
    {ln1, ln2 {scale}, attn {wq (D, H, Dh), wk, wv (D, Hkv, Dh), wo (H,
    Dh, D)[, q_norm, k_norm (Dh,)]}}. Dense weights are N(0, 1/fan_in),
    the embedding N(0, 0.02²), norm scales N(1, 0.1²)."""
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    H, Hkv, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    specs = [(("embed", "tok"), (V, D), 0.02, 0.0),
             (("embed", "head"), (D, V), D ** -0.5, 0.0),
             (("final_norm", "scale"), (D,), 0.1, 1.0),
             (("blocks", "ln1", "scale"), (L, D), 0.1, 1.0),
             (("blocks", "ln2", "scale"), (L, D), 0.1, 1.0),
             (("blocks", "attn", "wq"), (L, D, H, Dh), D ** -0.5, 0.0),
             (("blocks", "attn", "wk"), (L, D, Hkv, Dh), D ** -0.5, 0.0),
             (("blocks", "attn", "wv"), (L, D, Hkv, Dh), D ** -0.5, 0.0),
             (("blocks", "attn", "wo"), (L, H, Dh, D), (H * Dh) ** -0.5, 0.0)]
    if cfg.get("qk_norm"):
        specs += [(("blocks", "attn", "q_norm"), (L, Dh), 0.1, 1.0),
                  (("blocks", "attn", "k_norm"), (L, Dh), 0.1, 1.0)]
    return specs


def make_leaf(spec, seed: int, index: int, dtype, device) -> torch.Tensor:
    """Leaf ``index`` of a specs list, from its own generator: a stacked
    leaf is drawn layer by layer, each in one call."""
    from perfbench.harness.traffic import torch_seed
    path, shape, std, mean = spec
    s = torch_seed(seed, 100 + index)
    if len(path) == 3 and path[0] == "blocks" and len(shape) > 2:
        out = torch.empty(shape, dtype=dtype, device=device)
        g = torch.Generator(device=device).manual_seed(s)
        for i in range(shape[0]):
            out[i] = torch.randn(shape[1:], generator=g, dtype=dtype, device=device)
        if std != 1.0:
            out.mul_(std)
        if mean:
            out.add_(mean)
        return out
    return draw(shape, std, mean, s, dtype, device)


def make_tree(specs, seed: int, dtype, device) -> dict:
    tree: dict = {}
    for i, spec in enumerate(specs):
        put(tree, spec[0], make_leaf(spec, seed, i, dtype, device))
    return tree


def embed(params, tokens):
    return params["embed"]["tok"][tokens].float()


def logits_of_sequences(cfg: dict, params: dict, seqs, starts, ffn,
                        precision: str = "f32"):
    """The float32 forward of each token sequence in ``seqs`` (1-D long
    tensors on the weights' device), all layers, no cache: → for each, the
    logits (len - start, V) of its positions from ``starts[i]`` on. The
    FFN of a layer runs over every sequence's tokens at once
    (``ffn(cfg, p, h, precision)``)."""
    eps = cfg["rms_norm_eps"]
    xs = [embed(params, s) for s in seqs]
    pos = [torch.arange(s.shape[0], device=s.device) for s in seqs]
    lens = [s.shape[0] for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        p = layer_view(params["blocks"], i)
        xs = [attention_block(cfg, p, x, ps, precision) for x, ps in zip(xs, pos)]
        x = torch.cat(xs)
        x = x + ffn(cfg, p, rms_norm(x, p["ln2"]["scale"], eps), precision)
        xs = list(torch.split(x, lens))
    out = []
    for x, st in zip(xs, starts):
        h = rms_norm(x[st:], params["final_norm"]["scale"], eps)
        out.append(linear(h, params["embed"]["head"], precision))
    return out


def row_loss(cfg: dict, params: dict, tokens, ffn, precision: str = "f32"):
    """Mean next-token cross entropy of one row of tokens (S,): the
    forward with every layer recomputed in the backward, the head and the
    loss in blocks of positions."""
    eps = cfg["rms_norm_eps"]
    x = embed(params, tokens)
    pos = torch.arange(tokens.shape[0], device=tokens.device)

    def block(x, p):
        x = attention_block(cfg, p, x, pos, precision)
        return x + ffn(cfg, p, rms_norm(x, p["ln2"]["scale"], eps), precision)

    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(block, x, layer_view(params["blocks"], i),
                       use_reentrant=False)
    h = rms_norm(x, params["final_norm"]["scale"], eps)
    targets = torch.cat([tokens[1:], tokens.new_full((1,), -1)])
    return cross_entropy_sum(h, params["embed"]["head"], targets, precision) \
        / (tokens.shape[0] - 1)
