"""Partition specs: how every parameter, optimizer moment, batch field and
cache shards over the ("pod", "data", "model") mesh (the port of
``repro.sharding.specs``), and their DTensor placements.

Policies
--------
``tp``       Megatron-style tensor parallelism on the ``model`` axis
             (attention heads / FFN hidden / vocab), pure DP elsewhere.
``fsdp_tp``  ``tp`` plus parameters (and optimizer state) sharded over the
             data axes on a remaining dim — ZeRO-3-style per-layer
             all-gather under remat. Required for grok-1-314b
             (628 GB bf16 > 16 GB × 16-way TP).

Divisibility-aware fallbacks (a shard must tile its dim evenly):
  * attention heads shard over model when H % tp == 0, otherwise the
    projection replicates over model (qwen3 40H, smollm 15H/5KV, whisper
    6H, 8-KV GQA);
  * vocab shards over model when divisible (mamba2's 50280 and whisper's
    51865 are not → the embedding replicates over model);
  * any fsdp dim that doesn't tile the data axes falls back to replicated.

The builders are rule-based over tree paths + shapes, so any new module
following the naming conventions shards correctly without new code.

torch has no PartitionSpec: :class:`P` is one, a tuple whose entry for each
dim is None, a mesh axis name, or a tuple of names (the dim split over
their product, the first axis major). :func:`placements` turns it into
DTensor placements on a ``DeviceMesh`` with named dims, :func:`local_shape`
gives one shard's shape, and :func:`shard_tree` places a tree of full
tensors on a mesh: each rank slices its own shard and wraps it with
``DTensor.from_local`` (no collective runs, so a gloo group carries CUDA
shards too).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import leaves_with_paths, map_tree, unflatten_like

PRODUCTION_SIZES = {"pod": 2, "data": 16, "model": 16}


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), "model")``,
    ``P()`` (replicated). Immutable; compares as the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axes_size(ax, sizes) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= sizes[a]
        return n
    return sizes[ax]


def _fits(dim: int, ax, sizes) -> bool:
    return dim % _axes_size(ax, sizes) == 0


def _rule(path: str, shape: Tuple[int, ...], policy: str, dp, sizes):
    """→ spec entries for the *unstacked* param."""
    fsdp = dp if policy == "fsdp_tp" else None
    last = path.rsplit("/", 1)[-1]

    def f(dim_idx, ax=fsdp):
        """fsdp axis if it tiles this dim, else replicated."""
        return ax if (ax is not None and _fits(shape[dim_idx], ax, sizes)) else None

    def tp(dim_idx):
        return "model" if _fits(shape[dim_idx], "model", sizes) else None

    if path.endswith("embed/tok"):                       # (V, D)
        if _fits(shape[0], "model", sizes):
            return ("model", f(1))
        # non-divisible vocab (mamba2 50280, whisper 51865): replicate —
        # sharding D would make every logits matmul all-reduce a (B,S,V)
        return (f(0), None)
    if path.endswith("embed/head"):                      # (D, V)
        if _fits(shape[1], "model", sizes):
            return (f(0), "model")
        return (f(0), None)
    if path.endswith("vision_proj/w"):
        return (None, None)
    if last in ("wq", "wk", "wv"):                       # (D, H, Dh)
        if _fits(shape[1], "model", sizes):
            return (f(0), "model", None)
        # non-divisible heads (qwen3 40H, smollm 15/5, whisper 6, 8-KV GQA):
        # replicate over model — sharding Dh makes every attention dot
        # contract a sharded dim (an all-reduce per flash block). Attention
        # runs DP-only; the idle model axis shows up in the roofline compute
        # term.
        return (f(0), None, None)
    if last == "wo":                                     # (H, Dh, D)
        if _fits(shape[0], "model", sizes):
            return ("model", None, f(2))
        return (None, None, f(2))
    if last in ("gate", "up"):
        if len(shape) == 3:                              # moe (E, D, F)
            return (None, f(1), tp(2))
        return (f(0), tp(1))                             # dense (D, F)
    if last == "down":
        if len(shape) == 3:                              # moe (E, F, D)
            return (None, tp(1), f(2))
        return (tp(0), f(1))                             # dense (F, D)
    if last == "router":                                 # (D, E)
        return (f(0), None)
    if last == "in_proj":                                # (D, PO)
        return (f(0), tp(1))
    if last == "conv_w":                                 # (cw, C)
        return (None, tp(1))
    if last in ("conv_b", "dt_bias", "A_log", "D", "gate_norm"):
        return (tp(0),)
    if last == "out_proj":                               # (di, D)
        return (tp(0), f(1))
    return (None,) * len(shape)                          # norms, scalars


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` with named dims."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _map_specs(fn, tree):
    return unflatten_like(tree, [fn(p, leaf) for p, leaf in leaves_with_paths(tree)])


def param_specs(cfg: ModelConfig, params_tree, *, policy: str = "tp",
                dp=("data",), mesh=None, axis_sizes=None):
    """params_tree: tree of tensors (meta tensors will do) → tree of P."""
    sizes = axis_sizes or (mesh_sizes(mesh) if mesh is not None
                           else dict(PRODUCTION_SIZES))
    dp_entry = dp if len(dp) > 1 else dp[0]

    def spec_of(ps, leaf):
        stacked = ps.split("/")[0] in ("blocks", "enc_blocks")
        shape = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)
        entries = tuple(_rule(ps, shape, policy, dp_entry, sizes))[:len(shape)]
        entries = entries + (None,) * (len(shape) - len(entries))
        if stacked:
            entries = (None,) + entries
        return P(*entries)

    return _map_specs(spec_of, params_tree)


def opt_state_specs(cfg: ModelConfig, params_tree, *, dp=("data",), mesh=None,
                    axis_sizes=None):
    """ZeRO-1: moments shard like fsdp_tp params (sharded over data axes on
    top of TP) regardless of the param policy; scalar step replicated."""
    ps = param_specs(cfg, params_tree, policy="fsdp_tp", dp=dp, mesh=mesh,
                     axis_sizes=axis_sizes)
    return {"m": ps, "v": ps, "step": P()}


def batch_specs(cfg: ModelConfig, *, dp=("data",)):
    dpe = dp if len(dp) > 1 else dp[0]
    specs = {"tokens": P(dpe, None), "labels": P(dpe, None)}
    if cfg.vision_tokens:
        specs["vision_embeds"] = P(dpe, None, None)
    if cfg.enc_dec:
        specs["frames"] = P(dpe, None, None)
    return specs


def decode_state_specs(cfg: ModelConfig, state_tree, *, dp=("data",),
                       batch: int = 0, seq_shard=("model",)):
    """Cache sharding, rule-based over the decode-state tree
    (``models.init_decode_state`` on the meta device will do).

    KV-cache *sequence* dims shard over ``seq_shard`` — context parallelism,
    because KV head counts (5..32) never divide a 256-chip pod. When
    batch == 1 (long_500k) the data axes join the sequence shard so no mesh
    axis idles. SSM states shard heads over model (falling back to head_dim
    when heads don't divide); the conv tail shards channels over model. The
    position ``pos`` (a Python int in the port) is replicated."""
    dpe = dp if len(dp) > 1 else dp[0]
    sizes = dict(PRODUCTION_SIZES)
    if batch == 1:
        cache_b = None
        seq_axes = tuple(dp) + tuple(seq_shard)
        seq = seq_axes if len(seq_axes) > 1 else seq_axes[0]
    else:
        cache_b = dpe
        seq = seq_shard if len(seq_shard) > 1 else seq_shard[0]

    def spec_of(ps, leaf):
        last = ps.rsplit("/", 1)[-1]
        if last == "pos":
            return P()
        if last == "slot_pos":                     # (L, W)
            return P(None, seq)
        if last == "ssd":                          # (L, B, H, P, N)
            h_ok = leaf.shape[2] % _axes_size("model", sizes) == 0
            return (P(None, cache_b, "model", None, None) if h_ok
                    else P(None, cache_b, None, "model", None))
        if last == "conv":                         # (L, B, cw-1, C)
            return P(None, cache_b, None, "model")
        if "cross" in ps:                          # (L, B, Se, Hkv, Dh) — small
            return P(None, cache_b, None, None, None)
        if last in ("k", "v"):                     # (L, B, S, Hkv, Dh)
            return P(None, cache_b, seq, None, None)
        return P(*([None] * leaf.ndim))

    return _map_specs(spec_of, state_tree)


# ---------------------------------------------------------------------------
# placements: what GSPMD did for the reference
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where the spec splits tensor dim d over that axis, else
    ``Replicate()``. A dim split over several axes is ``Shard(d)`` on each,
    and DTensor splits it over them in mesh order, so the spec must name
    them in that order (as every rule above does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} is split over {axes}, out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} splits two dims")
            out[i] = Shard(d)
    return out


def local_shape(shape, spec: P, axis_sizes) -> Tuple[int, ...]:
    """One shard's shape of a ``shape`` tensor under ``spec`` on a mesh of
    ``axis_sizes`` ({axis: size}); every split dim must tile evenly."""
    out = []
    for d, n in enumerate(shape):
        k = _axes_size(spec[d] if d < len(spec) else None, axis_sizes)
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split into "
                             f"{k} shards under {spec}")
        out.append(n // k)
    return tuple(out)


def _device(mesh):
    import torch
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_slice(full, spec: P, mesh):
    """This rank's shard of the full tensor (or numpy array) ``full``
    under ``spec`` on ``mesh``, as a contiguous tensor on the mesh's
    device (a meta tensor's shard stays on the meta device: the dry run).
    Raises ValueError on a rank outside the mesh."""
    import numpy as np
    import torch
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank has no coordinate in the mesh")
    at = dict(zip(mesh.mesh_dim_names, coord))
    sizes = mesh_sizes(mesh)
    t = torch.from_numpy(np.ascontiguousarray(full)) if isinstance(full, np.ndarray) \
        else full
    index = []
    for d, n in enumerate(t.shape):
        axes = _entry_axes(spec[d] if d < len(spec) else None)
        k = math.prod(sizes[a] for a in axes)
        if n % k:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split into "
                             f"{k} shards under {spec}")
        i = 0
        for a in axes:                      # the first axis major
            i = i * sizes[a] + at[a]
        index.append(slice(i * (n // k), (i + 1) * (n // k)))
    dev = t.device if t.device.type == "meta" else _device(mesh)
    return t[tuple(index)].to(dev).contiguous()


def place(full, spec: P, mesh):
    """``full`` as a DTensor on ``mesh`` under ``spec``, from this rank's
    :func:`local_slice` (``DTensor.from_local``, no collective)."""
    import torch
    from torch.distributed.tensor import DTensor
    local = local_slice(full, spec, mesh)
    shape = torch.Size(full.shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=shape, stride=stride)


def shard_tree(tree, specs, mesh):
    """A tree of full tensors (or numpy arrays) placed on ``mesh`` by the
    matching tree of P: DTensors whose local shard each rank sliced itself.
    A leaf that is not an array (the decode state's int ``pos``) stays as
    it is."""
    import numpy as np
    import torch

    def one(leaf, spec):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            return place(leaf, spec, mesh)
        return leaf
    return map_tree(one, tree, specs)
