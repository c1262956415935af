"""Dry run: count every (architecture × input shape) cell of the port on a
mesh, with NO device allocation (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on the production meshes
from ShapeDtypeStructs. The port runs each cell's step on the meta device
under ``roofline.count``: parameters, optimizer state, batch and decode
state are meta tensors (on a mesh of more than one device, DTensors over
meta shards, placed by ``sharding.specs``), every aten op is counted on
the shards a device holds, each hand-written kernel by its ``cost``, and
DTensor's collectives by the ring formulas. A sharding mismatch, an op
DTensor cannot shard, or a host sync on the model path fails here, and
the cell prints FAIL with the op that stopped it.

Per cell it reports, per device: bytes by dtype of the parameters, the
gradients (``runtime.steps.train_grad_dtype``), the AdamW moments, the
batch and the decode state, exact from the local shapes; the activation
bytes of one microbatch (the tensors saved for backward, counted with
``torch.autograd.graph.saved_tensors_hooks``); the roofline against the
H100's peaks, ``model_flops`` and the useful share of the counted FLOPs;
and on one card whether it fits (``fits``) and the most layers that would
(``fits_depth``). A train step of more than four microbatches is counted
at 2 and 3 microbatches and extended linearly (every microbatch after the
first is the same work), so a 128-microbatch cell traces 5.

Meshes: ``1`` (one card, the default: plain meta tensors, no process
group), ``2x2`` (the fabric's four ranks), ``16x16`` and ``2x16x16`` (the
reference's production meshes; ``--multi-pod`` is the latter). A mesh of
more than one device is a ``fake`` process group in this process, seen
from rank 0; a caller that already holds a default process group runs the
cell in a subprocess.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells, mesh 1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k

Results go to ``artifacts/dryrun_torch/`` (git-ignored), one JSON file a
cell. The reference's ``Impl(attention="chunked", ...)`` has no
counterpart: the port's step is ``Impl(remat=True)`` with its kernels.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import replace as dc_replace
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs import (ARCH_IDS, SHAPES_BY_NAME, OptimizerConfig,
                                 TrainConfig, get_config, replace,
                                 shape_applicable)
from repro_torch.device import MetaGenerator
from repro_torch.models import init_decode_state, init_params
from repro_torch.models.transformer import Impl
from repro_torch.optim import init_opt_state
from repro_torch.roofline import count, model_flops
from repro_torch.runtime.steps import (make_decode_step, make_prefill_step,
                                       make_train_step, train_grad_dtype)
from repro_torch.tree import leaves, leaves_with_paths, unflatten_like

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

# Per-arch distribution choices, as the reference's
TRAIN_POLICY = {"grok-1-314b": "fsdp_tp", "mixtral-8x7b": "fsdp_tp"}
SERVE_POLICY = {"grok-1-314b": "fsdp_tp"}
TRAIN_PARAM_DTYPE = {"grok-1-314b": torch.bfloat16}
TRAIN_OPT_DTYPE = {"grok-1-314b": torch.bfloat16}
ROWS_PER_DEVICE = {"whisper-tiny": 4, "smollm-360m": 2, "olmo-1b": 2,
                   "llama3.2-1b": 2, "mamba2-1.3b": 2}

IMPL = Impl(remat=True)

# Head-padding targets for --opt-pad-heads (function-preserving; see
# configs/base.py). Constraint: kv_pad ≥ kv, g_pad ≥ g, (kv_pad·g_pad) % 16 == 0.
PAD_HEADS = {
    "qwen3-14b": dict(pad_q_heads=48, pad_kv_heads=8),     # g 5→6
    "smollm-360m": dict(pad_q_heads=32, pad_kv_heads=8),   # (5,3)→(8,4)
    "whisper-tiny": dict(pad_q_heads=16, pad_kv_heads=16), # (6,1)→(16,1)
}

MESHES = {"1": ((1,), ()), "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

H100_NAME = "NVIDIA H100 80GB HBM3"
H100_BYTES = 80 * 10 ** 9         # the data sheet's 80 GB


def apply_opts(cfg, impl, opts, kind="train"):
    """Beyond-paper optimization knobs, composable: ``moe_group`` (routing
    groups of that many tokens, 4096 by default) and ``pad_heads``
    (``PAD_HEADS``; at decode only where the kv head count is unchanged,
    since decode is bound by cache reads). ``zero_grads`` changes no
    config: ``build_cell`` places the gradients by the ``fsdp_tp`` specs.
    The reference's ``kv_chunk`` and ``anchor`` have no counterpart, and
    are refused: the port's kernels tile themselves, and every mesh cell
    of the port runs anchored (:func:`mesh_plan`), so there is no
    unanchored base to switch from."""
    why = {"kv_chunk": "its kernels tile themselves",
           "anchor": "every mesh cell runs anchored (launch.dryrun.mesh_plan)"}
    for knob, reason in why.items():
        if opts.get(knob):
            raise ValueError(f"the {knob!r} option has no counterpart in the port: "
                             f"{reason}")
    if opts.get("moe_group") and cfg.moe:
        g = opts["moe_group"] if isinstance(opts["moe_group"], int) and \
            opts["moe_group"] > 1 else 4096
        cfg = dc_replace(cfg, moe=dc_replace(cfg.moe, group_size=g))
    if opts.get("pad_heads") and cfg.name in PAD_HEADS:
        pads = PAD_HEADS[cfg.name]
        grows_kv = pads["pad_kv_heads"] > cfg.num_kv_heads
        if kind != "decode" or not grows_kv:
            cfg = dc_replace(cfg, **pads)
    return cfg, impl


def opts_tag(opts):
    parts = []
    if opts.get("moe_group"):
        g = opts["moe_group"] if isinstance(opts["moe_group"], int) and \
            opts["moe_group"] > 1 else 4096
        parts.append(f"moegrp{g}")
    if opts.get("pad_heads"):
        parts.append("padh")
    if opts.get("kv_chunk"):
        parts.append(f"kvc{opts['kv_chunk']}")
    if opts.get("zero_grads"):
        parts.append("zgrad")
    if opts.get("anchor"):
        parts.append("anchor")
    return "_".join(parts) if parts else "base"


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_like(cfg, B, S, *, dtype=torch.bfloat16):
    """Meta stand-ins for a batch of B × S tokens of ``cfg``."""
    batch = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = _meta((B, cfg.vision_tokens, cfg.vision_dim), dtype)
    if cfg.enc_dec:
        batch["frames"] = _meta((B, cfg.enc_ctx, cfg.d_model), dtype)
    return batch


def input_specs(arch: str, shape_name: str, *, dtype=torch.bfloat16):
    """Meta stand-ins for every model input of a cell."""
    cfg = get_config(arch)
    shp = SHAPES_BY_NAME[shape_name]
    B, S = shp.global_batch, shp.seq_len
    if shp.kind == "decode":
        return {"token": _meta((B, 1), torch.int32)}
    return batch_like(cfg, B, S, dtype=dtype)


# ---------------------------------------------------------------------------
# meshes and placement
# ---------------------------------------------------------------------------

_RULES = []


def register_dtensor_rules() -> None:
    """Sharding rules DTensor lacks for ops on the port's path (once):
    ``aten.mm.dtype`` (the LM head's bf16 product with an f32 output)
    shards as ``mm`` does."""
    if _RULES:
        return
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.mm.dtype)
    def _mm_dtype(x, w, out_dtype):
        return [([Replicate()], [Replicate(), Replicate(), None]),
                ([Shard(0)], [Shard(0), Replicate(), None]),
                ([Shard(1)], [Replicate(), Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]
    _RULES.append(_mm_dtype)


@contextlib.contextmanager
def fake_mesh(name: str):
    """The mesh ``name`` (not "1") as a ``DeviceMesh`` over a ``fake``
    process group of its size, seen from rank 0, for the block's length."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = MESHES[name]
    if dist.is_initialized():
        raise RuntimeError("a default process group exists; run the cell in a "
                           "subprocess (run_cell does)")
    n = math.prod(shape)
    register_dtensor_rules()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def _place(tree, specs, mesh):
    from repro_torch.sharding import shard_tree
    return tree if mesh is None else shard_tree(tree, specs, mesh)


def bytes_by_dtype(tree, itemsize_of=None) -> dict:
    """{dtype: bytes} of the tensor leaves of ``tree`` on one device (a
    DTensor's local shard); ``itemsize_of(leaf)`` → a dtype overrides the
    leaf's own (gradients)."""
    out = {}
    for _, t in leaves_with_paths(tree):
        if not isinstance(t, torch.Tensor):
            continue
        local = _local(t)
        dt = itemsize_of(t) if itemsize_of else local.dtype
        key = str(dt).removeprefix("torch.")
        out[key] = out.get(key, 0) + local.numel() * dt.itemsize
    return out


def saved_bytes(fn, *args, exclude=(), ctx=None) -> int:
    """Bytes of the distinct storages autograd saves for backward while
    ``fn(*args)`` runs, those of ``exclude`` (the parameters) left out: the
    activations a step holds between its forward and its backward. On
    DTensors, the local shards' (run under ``ctx()``)."""
    seen = {_local(t).untyped_storage()._cdata for t in exclude}
    ctx = ctx or contextlib.nullcontext
    total = 0

    def pack(t):
        nonlocal total
        storage = _local(t).untyped_storage()
        if storage._cdata not in seen:
            seen.add(storage._cdata)
            total += storage.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), ctx():
        fn(*args)
    return total


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

def _with_grad(params, fn):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        return fn()
    finally:
        for p in flat:
            p.requires_grad_(False)


# ---------------------------------------------------------------------------
# the plan on a mesh
# ---------------------------------------------------------------------------
# The port runs on one card: its model, runtime and optimizer have one
# code path, and no SPMD partitioner places what they compute. On a mesh
# the dry run says how a step is distributed, and :func:`mesh_plan` puts
# it in place for the length of the count, by wrapping a few functions of
# those modules:
#
# * every weight is gathered whole over the data axes as the step uses it
#   (ZeRO-3 for what ``fsdp_tp`` splits there), and its gradient is placed
#   back by the grad specs: the parameter's own, or ``fsdp_tp``'s under
#   ``zero_grads`` (the data-parallel reduce-scatter or all-reduce);
# * the residual stream is anchored, with its rows split over the data
#   axes and whole over ``model``, at each block's entry, at each attention
#   sublayer's output and at the input of the model's final norms, so a sublayer's Partial output is all-reduced there
#   (Megatron's plan; the reference's ``act_dp`` anchor, which it sets
#   with the ``anchor`` option): every mesh cell of the port runs anchored;
# * each microbatch takes its rows from every local shard, so it stays
#   split over the data axes as the reference's reshape keeps it;
# * the MoE layer routes each device's own tokens, and each hand-written
#   kernel runs on the local shards (DTensor has no rule for either);
# * AdamW takes a DTensor leaf as one piece, its local shard.


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _rows(x) -> list:
    """Placements of an activation with its rows split over the data axes
    (whole where they do not divide) and whole over ``model``."""
    mesh = x.device_mesh
    return [Replicate() if name == "model" or x.shape[0] % mesh.size(i) else Shard(0)
            for i, name in enumerate(mesh.mesh_dim_names)]


class _Anchor(torch.autograd.Function):
    """Redistribute to ``want`` forward, and place the gradient the same way
    backward (Megatron's all-reduce forward, identity backward; the
    transpose of a sharding constraint): a Partial input's gradient is the
    whole gradient, and left to itself DTensor would meet a Partial
    gradient by gathering the next weight instead."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.want), None


def anchor(x):
    """``x`` placed by :func:`_rows`; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    want = _rows(x)
    return x if list(x.placements) == want else _Anchor.apply(x, want)


class _Gather(torch.autograd.Function):
    """A weight whole over every mesh dim but ``model`` forward; backward,
    its gradient placed by ``grad`` (a list of placements)."""

    @staticmethod
    def forward(ctx, w, grad):
        ctx.grad = grad
        return w.redistribute(w.device_mesh, [
            p if name == "model" else Replicate()
            for name, p in zip(w.device_mesh.mesh_dim_names, w.placements)])

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.grad), None


def gathered(params, grad_placements=None):
    """``params`` with every leaf gathered by :class:`_Gather`, each
    gradient placed by ``grad_placements`` (a list in leaf order; default
    each parameter's own placements)."""
    flat = leaves(params)
    grad_placements = grad_placements or [list(w.placements) for w in flat]
    return unflatten_like(params, [_Gather.apply(w, g)
                                   for w, g in zip(flat, grad_placements)])


def _microbatch_of_shards(plain):
    def microbatch(v, i, n_micro):
        if not isinstance(v, DTensor):
            return plain(v, i, n_micro)
        local = v.to_local()
        r = local.shape[0] // n_micro
        return DTensor.from_local(local[i * r:(i + 1) * r], v.device_mesh,
                                  v.placements, run_check=False)
    return microbatch


def _pieces_of_shards(plain):
    return lambda t, n: (t,) if isinstance(t, DTensor) else plain(t, n)


def _anchor_in(block):
    """A block, or a norm, with its input ``x`` (the third argument) anchored."""
    return lambda cfg, p, x, *a, **k: block(cfg, p, anchor(x), *a, **k)


def _anchor_out(sublayer):
    """A sublayer with its output anchored (the first, where it returns a
    tuple)."""
    def run(*a, **k):
        out = sublayer(*a, **k)
        return (anchor(out[0]), *out[1:]) if isinstance(out, tuple) else anchor(out)
    return run


def _like(local, like, dims=None, partial_on=()):
    """``local`` (one device's result) as a DTensor on ``like``'s mesh:
    ``like``'s placements with its tensor dim d mapped to ``dims[d]`` (a
    dim missing from ``dims`` replicated), and the mesh dims of
    ``partial_on`` Partial."""
    out = []
    for i, p in enumerate(like.placements):
        if i in partial_on:
            out.append(Partial())
        elif isinstance(p, Shard) and dims is not None:
            out.append(Shard(dims[p.dim]) if p.dim in dims else Replicate())
        else:
            out.append(p)
    return DTensor.from_local(local, like.device_mesh, out, run_check=False)


def _attention_on_shards(kernel):
    def attention(q, k, v, q_pos, kv_pos, **kw):
        return _like(kernel(*map(_local, (q, k, v, q_pos, kv_pos)), **kw), q)
    return attention


def _decode_on_shards(kernel):
    """A cache split along its sequence: the query gathered over those mesh
    dims, and the output Partial there (the combine of partial softmaxes)."""
    def decode_attention(q, k, v, q_pos, kv_pos, **kw):
        split = [i for i, p in enumerate(k.placements) if p == Shard(1)]
        if split:
            q = q.redistribute(q.device_mesh, [Replicate() if i in split else p
                                               for i, p in enumerate(q.placements)])
        out = kernel(*map(_local, (q, k, v, q_pos, kv_pos)), **kw)
        return _like(out, q, partial_on=split)
    return decode_attention


def _ssd_on_shards(kernel):
    def ssd(x, dt, A_log, B, C, D, init_state=None, **kw):
        y, final = kernel(*map(_local, (x, dt, A_log, B, C, D, init_state)), **kw)
        return _like(y, x), _like(final, x, dims={0: 0, 2: 1, 3: 2})
    return ssd


def _moe_on_shards(apply_moe):
    """The MoE layer on each device's local shards (the routing has
    data-dependent indices no DTensor rule shards): the tokens split over
    the data axes (whole where the rows do not split evenly) and whole
    over ``model``, the router whole, the experts' F dim split over
    ``model`` where its spec splits it. Each device routes its tokens as
    one group; the output is a Partial sum over ``model`` when F is split
    there, and the aux terms the mean over the data axes."""
    def moe(cfg, p, x):
        mesh = x.device_mesh
        names = mesh.mesh_dim_names
        tp = [i for i, n in enumerate(names) if n == "model"]

        def on(t, placements):
            return t.redistribute(mesh, placements).to_local()

        rows = _rows(x)
        f_split = {i for i, pl in enumerate(p["gate"].placements)
                   if i in tp and pl == Shard(2)}

        def keep_f(d):
            return [Shard(d) if i in f_split else Replicate() for i in range(len(names))]
        local = {"router": on(p["router"], [Replicate()] * len(names)),
                 "gate": on(p["gate"], keep_f(2)), "up": on(p["up"], keep_f(2)),
                 "down": on(p["down"], keep_f(1))}
        y, aux = apply_moe(cfg, local, on(x, rows))
        y = DTensor.from_local(y, mesh, [Partial() if i in f_split else pl
                                         for i, pl in enumerate(rows)],
                               run_check=False, shape=x.shape, stride=x.stride())
        mean = [Replicate() if i in tp else Partial("avg") for i in range(len(names))]
        return y, {k: DTensor.from_local(v, mesh, mean, run_check=False)
                   for k, v in aux.items()}
    return moe


@contextlib.contextmanager
def mesh_plan(cfg, pspecs, grad_placements=None):
    """What a step runs under on a mesh: the wrappers above in place; plain
    tensors beside DTensors (positions, masks the model builds) counted as
    replicated; and where the LM head splits the vocabulary over ``model``
    the cross entropy on the split logits (``loss_parallel``) instead of
    gathering them. ``grad_placements``: see :func:`gathered`."""
    from unittest import mock

    from torch.distributed.tensor.experimental import implicit_replication
    from torch.distributed.tensor.parallel import loss_parallel
    mods = {name: importlib.import_module(f"repro_torch.{name}") for name in (
        "models.attention", "models.model", "models.moe", "models.ssm",
        "models.transformer", "optim.adamw", "runtime.steps")}

    def gathering(loss_fn):
        return lambda cfg, params, batch, **kw: loss_fn(
            cfg, gathered(params, grad_placements), batch, **kw)
    with contextlib.ExitStack() as stack:
        for mod, name, wrap in (
                ("runtime.steps", "loss_fn", gathering),
                ("runtime.steps", "_microbatch", _microbatch_of_shards),
                ("optim.adamw", "_pieces", _pieces_of_shards),
                ("models.moe", "apply_moe", _moe_on_shards),
                ("models.transformer", "_attn_block", _anchor_in),
                ("models.transformer", "_mamba_block", _anchor_in),
                ("models.transformer", "apply_dec_block", _anchor_in),
                ("models.transformer", "_decode_attn_block", _anchor_in),
                ("models.transformer", "_decode_mamba_block", _anchor_in),
                ("models.transformer", "decode_dec_block", _anchor_in),
                ("models.attention", "apply_attn", _anchor_out),
                ("models.attention", "apply_cross_attn", _anchor_out),
                ("models.attention", "decode_attn", _anchor_out),
                ("models.model", "apply_norm", _anchor_in)):
            owner = mods[mod]
            stack.enter_context(mock.patch.object(owner, name, wrap(getattr(owner, name))))
        for mod, table, wrap in (("models.attention", "_ATTN_IMPLS", _attention_on_shards),
                                 ("models.attention", "_DECODE_IMPLS", _decode_on_shards),
                                 ("models.ssm", "_SSD_IMPLS", _ssd_on_shards)):
            impls = getattr(mods[mod], table)
            stack.enter_context(mock.patch.dict(impls, {"kernel": wrap(impls["kernel"])}))
        stack.enter_context(implicit_replication())
        if "model" in pspecs["embed"]["tok" if cfg.tie_embeddings else "head"]:
            stack.enter_context(loss_parallel())
        yield


def _counted(fn, *args, mesh=None, ctx=contextlib.nullcontext):
    """The Cost of ``fn(*args)`` under ``ctx()``. On a mesh the call runs
    once first, uncounted: DTensor's first dispatch of an op computes
    shard shapes with meta ops of its own, which later calls find cached."""
    with ctx():
        if mesh is not None:
            fn(*args)
        return count(fn, *args)[1]


def _combine(c_a, c_b, n_a, n):
    """Counts of a call of n microbatches from those of n_a and n_a + 1
    (``c_a``, ``c_b``): every microbatch past the first is the same work."""
    from repro_torch.roofline.count import Cost
    k = n - n_a

    def lin(a, b):
        return a + k * (b - a)
    out = Cost(bytes=lin(c_a.bytes, c_b.bytes), n_coll=int(lin(c_a.n_coll, c_b.n_coll)),
               n_ops=int(lin(c_a.n_ops, c_b.n_ops)))
    for key in set(c_a.flops_by_dtype) | set(c_b.flops_by_dtype):
        out.flops_by_dtype[key] = lin(c_a.flops_by_dtype.get(key, 0.0),
                                      c_b.flops_by_dtype.get(key, 0.0))
    for key in set(c_a.coll_by_kind) | set(c_b.coll_by_kind):
        out.coll_by_kind[key] = lin(c_a.coll_by_kind.get(key, 0.0),
                                    c_b.coll_by_kind.get(key, 0.0))
    for key in set(c_a.kernels) | set(c_b.kernels):
        a = c_a.kernels.get(key, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        b = c_b.kernels.get(key, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        out.kernels[key] = {f: type(a[f])(lin(a[f], b[f])) for f in a}
    return out


@dataclasses.dataclass
class Cell:
    """A cell's step and its inputs on the meta device (DTensors over meta
    shards on a mesh), what it runs under, and its bytes of state."""
    fn: Callable
    args: tuple
    state: dict                             # {part: {dtype: bytes}}
    ctx: Callable = contextlib.nullcontext
    n_micro: int = 1
    args_of: Optional[Callable] = None      # train: the args with n microbatches
    act: Optional[Callable] = None          # train: → one microbatch's saved bytes


def build_cell(cfg, kind: str, B: int, S: int, *, micro: int = 1,
               param_dtype=torch.float32, opt_dtype=torch.float32,
               dtype=torch.bfloat16, impl: Impl = IMPL, mesh=None,
               policy: str = "tp", dp=("data",), zero_grads: bool = False) -> Cell:
    """The step of ``cfg`` (kind "train", "prefill" or "decode") on a
    global batch of B × S (decode: B rows, a cache of S) in ``dtype``
    compute, with its inputs placed on ``mesh`` (None: one device) by the
    partition specs and run under :func:`mesh_plan`. Train: ``param_dtype``
    parameters, ``opt_dtype`` moments, microbatches of ``micro`` rows,
    gradients placed by the ``fsdp_tp`` specs under ``zero_grads`` (as the
    reference's ``grad_specs``; on one device they are whole either way),
    else as their parameters; serving: ``dtype`` weights."""
    from repro_torch.sharding import (P, batch_specs, decode_state_specs,
                                      opt_state_specs, param_specs, placements)
    params = init_params(cfg, MetaGenerator(),
                         dtype=param_dtype if kind == "train" else dtype)
    pspecs = param_specs(cfg, params, policy=policy, dp=dp, mesh=mesh) \
        if mesh is not None else None
    full_params, params = params, _place(params, pspecs, mesh)
    state = {"params": bytes_by_dtype(params)}
    ctx = contextlib.nullcontext
    if kind == "train":
        n_micro = max(1, B // micro)
        gdt = train_grad_dtype(param_dtype, n_micro)
        grads = params
        if mesh is not None:
            if zero_grads:
                gspecs = param_specs(cfg, full_params, policy="fsdp_tp", dp=dp, mesh=mesh)
                grads = _place(full_params, gspecs, mesh)
            places = [list(g.placements) for g in leaves(grads)]
            ctx = lambda: mesh_plan(cfg, pspecs, places)     # noqa: E731
        opt = init_opt_state(full_params, opt_dtype)
        if mesh is not None:
            ospecs = opt_state_specs(cfg, opt["m"], dp=dp, mesh=mesh)
            opt = {"m": _place(opt["m"], ospecs["m"], mesh),
                   "v": _place(opt["v"], ospecs["v"], mesh)}
        opt["step"] = torch.zeros((), dtype=torch.int32)     # a host counter here
        state["grads"] = bytes_by_dtype(grads, lambda _: gdt)
        state["moments"] = bytes_by_dtype({"m": opt["m"], "v": opt["v"]})

        def args_of(n):
            b = batch_like(cfg, n * micro, S, dtype=dtype)
            return params, opt, _place(b, batch_specs(cfg, dp=dp) if mesh is not None
                                       else None, mesh)
        args = args_of(n_micro)
        state["batch"] = bytes_by_dtype(args[2])
        tcfg = TrainConfig(microbatch_size=micro, dtype=str(dtype).removeprefix("torch."),
                           param_dtype=str(param_dtype).removeprefix("torch."),
                           optimizer=OptimizerConfig(total_steps=10_000))
        one = args_of(1)[2]

        def act():       # the train step's loss_fn, the plan's under ctx
            steps = importlib.import_module("repro_torch.runtime.steps")
            return _with_grad(params, lambda: saved_bytes(
                lambda: steps.loss_fn(cfg, params, one, impl=impl, dtype=dtype),
                exclude=leaves(params), ctx=ctx))
        return Cell(make_train_step(cfg, tcfg, impl), args, state, ctx, n_micro,
                    args_of, act)
    if kind == "prefill":
        batch = batch_like(cfg, B, S, dtype=dtype)
        batch.pop("labels")
        if mesh is not None:
            bspecs = batch_specs(cfg, dp=dp)
            bspecs.pop("labels")
            batch = _place(batch, bspecs, mesh)
        state["batch"] = bytes_by_dtype(batch)
        return Cell(_serve(make_prefill_step(cfg, impl, dtype=dtype), mesh), (params, batch),
                    state, _serve_ctx(cfg, pspecs, mesh))
    enc_out = _meta((B, cfg.enc_ctx, cfg.d_model), dtype) if cfg.enc_dec else None
    dstate = init_decode_state(cfg, B, S, dtype=dtype, device="meta",
                               params=full_params if cfg.enc_dec else None,
                               enc_out=enc_out)
    token = _meta((B, 1), torch.int32)
    if mesh is not None:
        dstate = _place(dstate, decode_state_specs(cfg, dstate, dp=dp, batch=B), mesh)
        dpe = dp if len(dp) > 1 else dp[0]
        token = _place(token, P(dpe, None) if B > 1 else P(None, None), mesh)
    state["decode_state"] = bytes_by_dtype(dstate)
    return Cell(_serve(make_decode_step(cfg, impl, dtype=dtype), mesh),
                (params, dstate, token), state, _serve_ctx(cfg, pspecs, mesh))


def _serve(step, mesh):
    """A serving step that gathers its weights first on a mesh."""
    return step if mesh is None else lambda params, *a: step(gathered(params), *a)


def _serve_ctx(cfg, pspecs, mesh):
    return contextlib.nullcontext if mesh is None else lambda: mesh_plan(cfg, pspecs)


def count_step(cfg, kind: str, B: int, S: int, *, costs: bool = True, **kw) -> dict:
    """Count one step of :func:`build_cell`'s cell (same arguments).
    ``costs=False`` counts the bytes of state and activations only.
    → {"cost" (None without costs), "state" {part: {dtype: bytes}},
    "state_bytes", "act_bytes", "n_micro"}."""
    cell = build_cell(cfg, kind, B, S, **kw)
    mesh = kw.get("mesh")
    cost = None
    if costs and cell.n_micro <= 4:
        cost = _counted(cell.fn, *cell.args, mesh=mesh, ctx=cell.ctx)
    elif costs:
        c2 = _counted(cell.fn, *cell.args_of(2), mesh=mesh, ctx=cell.ctx)
        c3 = _counted(cell.fn, *cell.args_of(3), mesh=mesh, ctx=cell.ctx)
        cost = _combine(c2, c3, 2, cell.n_micro)
    return {"cost": cost, "state": cell.state, "n_micro": cell.n_micro,
            "act_bytes": cell.act() if cell.act else 0,
            "state_bytes": sum(sum(v.values()) for k, v in cell.state.items()
                               if k != "batch")}


def card_capacity():
    """(bytes, name) of the card this runs beside: the CUDA card's memory
    when one is present, else the H100 80GB's."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                torch.cuda.get_device_name(0))
    return H100_BYTES, f"{H100_NAME} (data sheet)"


def _unit(cfg) -> int:
    """Layers that repeat as one: the hybrid family's period of mamba
    blocks around one shared attention block, else one layer."""
    return cfg.attn_every if cfg.family == "hybrid" else 1


def fits_depth(cfg, kind, B, S, capacity, **kw) -> dict:
    """The most layers of ``cfg`` whose state plus activations (plus, under
    remat, one layer's recomputed activations during the backward) fit
    ``capacity`` bytes, from the bytes at one and two units of depth (both
    grow linearly in depth) → {"fits_depth", "need_bytes" (at cfg's own
    depth), "bytes_per_unit", "unit_layers", "base_bytes"}."""
    u = _unit(cfg)
    impl = kw.pop("impl", IMPL)

    def need(layers, imp):
        r = count_step(replace(cfg, num_layers=layers), kind, B, S, impl=imp,
                       costs=False, **kw)
        return r["state_bytes"] + r["act_bytes"]
    one, two = need(u, impl), need(2 * u, impl)
    per = two - one
    extra = 0
    if impl.remat and kind == "train":
        plain = Impl(**{**dataclasses.asdict(impl), "remat": False})
        extra = need(2 * u, plain) - need(u, plain) - per
    base = one - per + extra
    depth = max(0, int((capacity - base) // per)) * u if per > 0 else cfg.num_layers
    return {"fits_depth": depth, "need_bytes": base + per * (cfg.num_layers // u),
            "bytes_per_unit": per, "unit_layers": u, "base_bytes": base}


def cell_record(cfg, kind, B, S, r, n_dev, *, tokens=None) -> dict:
    """The counted step ``r`` (``count_step``) as a cell's fields."""
    roof = r["cost"].roofline()
    tokens = tokens if tokens is not None else (B * S if kind != "decode" else B)
    mfl = model_flops(cfg.active_param_count(), tokens, kind)
    return {
        "devices": n_dev, "n_micro": r["n_micro"],
        "memory": {part: v for part, v in r["state"].items()},
        "state_bytes": r["state_bytes"], "act_bytes": r["act_bytes"],
        "kernels": r["cost"].kernels, "n_ops": r["cost"].n_ops,
        "roofline": roof.to_dict(), "t_bound_s": roof.t_bound,
        "model_flops_global": mfl, "model_flops_per_device": mfl / n_dev,
        "useful_flops_ratio": (mfl / n_dev) / roof.flops if roof.flops else None,
    }


def run_cell(arch: str, shape_name: str, *, mesh: str = "1", save: bool = True,
             opts=None, cfg=None, shape=None) -> dict:
    """Count one (arch × shape) cell on ``mesh`` ("1", "2x2", "16x16",
    "2x16x16") → its record; ``cfg`` and ``shape`` (a ``ShapeConfig``)
    replace the published configuration and the cell's shape (tests count
    reduced ones at small shapes)."""
    import torch.distributed as dist
    opts = opts or {}
    if mesh != "1" and dist.is_initialized():
        if cfg is not None or shape is not None:
            raise ValueError("a subprocess cell takes the published config and shape")
        return _run_cell_subprocess(arch, shape_name, mesh, save, opts)
    cfg = cfg or get_config(arch)
    shp = shape or SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shp)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh, "kind": shp.kind,
              "status": "skip", "skip_reason": why, "opts": opts_tag(opts)}
    if not ok:
        return result
    cfg, impl = apply_opts(cfg, IMPL, opts, kind=shp.kind)
    shape, axes = MESHES[mesh]
    n_dev = math.prod(shape)
    multi_pod = "pod" in axes
    dp = ("pod", "data") if multi_pod else ("data",)
    B, S = shp.global_batch, shp.seq_len
    kw = {}
    if shp.kind == "train":
        kw = dict(micro=n_dev // shape[-1] * ROWS_PER_DEVICE.get(arch, 1)
                  if n_dev > 1 else ROWS_PER_DEVICE.get(arch, 1),
                  param_dtype=TRAIN_PARAM_DTYPE.get(arch, torch.float32),
                  opt_dtype=TRAIN_OPT_DTYPE.get(arch, torch.float32),
                  zero_grads=bool(opts.get("zero_grads")))
        policy = TRAIN_POLICY.get(arch, "tp")
    else:
        policy = SERVE_POLICY.get(arch, "tp")
    t0 = time.perf_counter()
    with (fake_mesh(mesh) if n_dev > 1 else contextlib.nullcontext()) as m:
        r = count_step(cfg, shp.kind, B, S, impl=impl, mesh=m, policy=policy, dp=dp,
                       **kw)
    result.update(status="ok", count_s=time.perf_counter() - t0,
                  policy=policy, **cell_record(cfg, shp.kind, B, S, r, n_dev))
    if n_dev == 1:
        cap, card = card_capacity()
        result.update(card=card, capacity_bytes=cap,
                      fits=r["state_bytes"] + r["act_bytes"] <= cap,
                      **fits_depth(cfg, shp.kind, B, S, cap, impl=impl, **kw))
    if save:
        os.makedirs(ARTIFACTS, exist_ok=True)
        tag = opts_tag(opts)
        suffix = "" if tag == "base" else f"__{tag}"
        with open(os.path.join(ARTIFACTS, f"{arch}__{shape_name}__{mesh}{suffix}.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    return result


def _run_cell_subprocess(arch, shape_name, mesh, save, opts) -> dict:
    """``run_cell`` in a fresh interpreter (this one holds a default
    process group, and a fake one cannot sit beside it)."""
    code = ("import json, sys; from repro_torch.launch.dryrun import run_cell; "
            "print(json.dumps(run_cell(*sys.argv[1:3], mesh=sys.argv[3], "
            "save=sys.argv[4] == '1', opts=json.loads(sys.argv[5]))))")
    src = os.path.join(os.path.dirname(__file__), "..", "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    proc = subprocess.run([sys.executable, "-c", code, arch, shape_name, mesh,
                           "1" if save else "0", json.dumps(opts)],
                          capture_output=True, text=True, env=env, timeout=3600)
    if proc.returncode:
        raise RuntimeError(f"dry run of {arch} {shape_name} on {mesh} failed:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def failing_op(exc: BaseException) -> str:
    """The op or function that stopped a cell: the innermost frame of the
    traceback inside the port, with the exception's first line."""
    frames = traceback.extract_tb(exc.__traceback__)
    port = [f for f in frames if "repro_torch" in f.filename
            and "launch/dryrun" not in f.filename and "roofline/count" not in f.filename]
    where = port[-1] if port else (frames[-1] if frames else None)
    at = f"{os.path.relpath(where.filename)}:{where.lineno} {where.line}" if where else "?"
    msg = (str(exc).strip().splitlines() or [""])[0][:300]
    return f"{type(exc).__name__} at {at}: {msg}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES_BY_NAME))
    ap.add_argument("--mesh", default="1", choices=list(MESHES))
    ap.add_argument("--multi-pod", action="store_true", help="--mesh 2x16x16")
    ap.add_argument("--opt-moe-group", type=int, nargs="?", const=4096, default=0)
    ap.add_argument("--opt-pad-heads", action="store_true")
    ap.add_argument("--opt-kv-chunk", type=int, default=0)
    ap.add_argument("--opt-zero-grads", action="store_true")
    ap.add_argument("--opt-anchor-acts", action="store_true")
    args = ap.parse_args(argv)
    mesh = "2x16x16" if args.multi_pod else args.mesh
    opts = {"moe_group": args.opt_moe_group, "pad_heads": args.opt_pad_heads,
            "kv_chunk": args.opt_kv_chunk, "zero_grads": args.opt_zero_grads,
            "anchor": args.opt_anchor_acts}
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES_BY_NAME)

    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch:24s} {shape:12s} {mesh:8s}"
            try:
                r = run_cell(arch, shape, mesh=mesh, opts=opts)
            except Exception as e:
                failures += 1
                print(f"FAIL {tag} {failing_op(e)}", flush=True)
                continue
            if r["status"] == "skip":
                print(f"SKIP {tag} {r['skip_reason']}", flush=True)
                continue
            roof = r["roofline"]
            fit = ""
            if "fits" in r:
                fit = f" fits={r['fits']}" + (f" fits_depth={r['fits_depth']}"
                                             if "fits_depth" in r else "")
            print(f"OK   {tag} count={r['count_s']:6.1f}s "
                  f"state/dev={r['state_bytes'] / 2**30:8.2f}GiB "
                  f"act/dev={r['act_bytes'] / 2**30:7.2f}GiB "
                  f"flops/dev={roof['flops']:.3e} "
                  f"coll={roof['collective_bytes'] / 2**20:9.1f}MiB "
                  f"bound={roof['bottleneck']} t_bound={r['t_bound_s'] * 1e3:.2f}ms"
                  f"{fit}", flush=True)
    print(f"\ndone; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
