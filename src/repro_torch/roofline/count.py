"""Counting a step's work on the meta device (the counterpart of
``repro.roofline.hlo_parse.ModuleCost``).

:func:`count` runs ``fn`` under a ``TorchDispatchMode`` that sees every
aten op the step dispatches, on plain meta tensors or on the local
shards of DTensors, and adds up:

* FLOPs by dtype, from ``torch.utils.flop_counter``'s registered formulas
  (matmuls, convolutions, attention; elementwise ops count none, as in
  ``FlopCounterMode``), keyed by the dtype of the op's first tensor input;
* bytes: every operand read once and every result written once, an upper
  bound as the reference's ``hbm_bytes_upper`` is (views and
  uninitialised allocations move nothing; an expanded dimension is read
  once);
* each hand-written kernel by its own ``cost`` (on a meta tensor
  ``kernels.ops`` hands it to its ``cost_hook``, which :func:`count` sets
  to :func:`record_kernel`, and no aten op runs inside);
* DTensor's collectives (``_c10d_functional`` ops), by kind and group size,
  with ``analyze.moved_bytes``'s ring formulas.

Under DTensor the counts are per device: DTensor hands this mode the ops it
runs on its local shards, and the global-shape ops of its sharding
propagation (run on FakeTensors) are not counted. On one device the
counts are the whole step's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analyze import Roofline, moved_bytes

_DTYPE = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
          torch.float64: "f64"}

# allocations that write nothing, and a view of a fresh result that
# reads nothing (the tag-based ``is_view`` does not cover it)
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided", "aten::_unsafe_view"}

_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def dtype_key(dtype: torch.dtype) -> str:
    """The roofline's name for a floating dtype ("bf16", "f32", ...); any
    other dtype counts at the f32 peak."""
    return _DTYPE.get(dtype, "f32")


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a kernel reads or writes for ``t``: its elements, a broadcast
    (stride 0) dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


@dataclass
class Cost:
    """Per-device work of one call: FLOPs by dtype, bytes, collectives by
    kind (bytes moved over the bottleneck link), and each kernel's launches,
    FLOPs and bytes."""
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    n_coll: int = 0
    kernels: Dict[str, dict] = field(default_factory=dict)
    n_ops: int = 0

    @property
    def flops(self) -> float:
        return sum(self.flops_by_dtype.values())

    def add_flops(self, dtype: str, n: float) -> None:
        if n:
            self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + n

    def roofline(self) -> Roofline:
        return Roofline(self.flops, self.bytes, sum(self.coll_by_kind.values()),
                        self.n_coll, dict(self.coll_by_kind),
                        hbm_bytes_upper=self.bytes,
                        flops_by_dtype=dict(self.flops_by_dtype))


# the innermost count()'s Cost: a module global, not a thread-local, since
# autograd may run a backward on a thread of its own
_ACTIVE: list = []


def record_kernel(name: str, kcost: dict) -> None:
    """Add one launch of the hand-written kernel ``name`` with its cost
    ({"flops", "bytes", "dtype"}, the kernel module's ``cost``) to the
    innermost :func:`count` (a no-op outside one)."""
    if not _ACTIVE:
        return
    cost = _ACTIVE[-1]
    k = cost.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
    k["launches"] += 1
    k["flops"] += kcost["flops"]
    k["bytes"] += kcost["bytes"]
    cost.add_flops(dtype_key(kcost["dtype"]), kcost["flops"])
    cost.bytes += kcost["bytes"]


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a functional collective names."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for i, arg in enumerate(func._schema.arguments):
        if arg.name == "group_name":
            name = args[i] if i < len(args) else kwargs["group_name"]
            return _resolve_process_group(name).size()
    return 1


class CountMode(TorchDispatchMode):
    """Adds each dispatched aten op's FLOPs, bytes and collectives to
    ``cost``. A DTensor op is handed back to DTensor (NotImplemented), which
    dispatches its local ops through this mode again."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        flat_out = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if any(_is_fake(t) for t in flat_in + flat_out):
            return out                       # DTensor's shape propagation
        self._add(func, args, kwargs, out, flat_in, flat_out)
        return out

    def _add(self, func, args, kwargs, out, flat_in, flat_out):
        cost = self.cost
        cost.n_ops += 1
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(func._opname)
            if kind is not None:
                nbytes = sum(tensor_bytes(o) for o in flat_out)
                cost.coll_by_kind[kind] = cost.coll_by_kind.get(kind, 0.0) + \
                    moved_bytes(kind, nbytes, _group_size(func, args, kwargs))
                cost.n_coll += 1
            return
        if func.is_view or func._schema.name in _NO_TRAFFIC:
            return
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and flat_in:
            cost.add_flops(dtype_key(flat_in[0].dtype),
                           float(formula(*args, **kwargs, out_val=out)))
        cost.bytes += sum(tensor_bytes(t) for t in flat_in) + \
            sum(tensor_bytes(t) for t in flat_out)


def count(fn, *args, **kwargs):
    """→ (fn's result, :class:`Cost` of the call). Run it on meta tensors
    (or DTensors over meta shards) to count a step without running it;
    on real tensors it counts all the same (the CPU's plain versions of
    the kernels are then counted as their aten ops)."""
    from repro_torch.kernels import ops
    cost = Cost()
    _ACTIVE.append(cost)
    hook, ops.cost_hook = ops.cost_hook, record_kernel
    try:
        with CountMode(cost):
            result = fn(*args, **kwargs)
    finally:
        ops.cost_hook = hook
        _ACTIVE.pop()
    return result, cost
