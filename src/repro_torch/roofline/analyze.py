"""The roofline of a step on one NVIDIA H100 (the port of
``repro.roofline.analyze``).

Three terms per (arch × shape × mesh), all in seconds:

  compute    = Σ over dtypes of FLOPs_per_device / that dtype's peak
  memory     = bytes_per_device / HBM bandwidth
  collective = Σ per-op bytes moved per device / link bandwidth

The counts come from ``roofline.count`` (aten ops on the meta device, each
hand-written kernel by its ``cost``, DTensor's collectives), not from
compiled HLO. A collective's bytes moved per device over the bottleneck
link follow the ring algorithm, as the reference's do:

  all-reduce         2·(g-1)/g · bytes       (reduce-scatter + all-gather)
  all-gather           (g-1)/g · bytes       (bytes = gathered result)
  reduce-scatter       (g-1)   · bytes       (bytes = scattered result)
  all-to-all           (g-1)/g · bytes
  collective-permute           · bytes

g = the size of the op's process group.

Hardware model: the H100 SXM data sheet (dense, no sparsity): 989 TFLOP/s
in bf16 and f16 on the tensor cores, 67 TFLOP/s in f32 without TF32 (the
port turns TF32 off, ``device.resolve``) and in f64, 3.35 TB/s of HBM3,
450 GB/s a direction over NVLink 4.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12, "f64": 67e12}
HBM_BW = 3.35e12             # bytes/s / card
LINK_BW = 450e9              # bytes/s / card, NVLink 4, one direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def moved_bytes(kind: str, result_bytes: float, group_size: int) -> float:
    """Bytes one device moves over its bottleneck link for a collective of
    ``kind`` whose result is ``result_bytes`` on each device, in a group of
    ``group_size`` (the ring costs above)."""
    g = group_size
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / g * result_bytes
    if kind == "reduce-scatter":
        return float(g - 1) * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective {kind!r}")


def bound(nbytes: float, ops: float, kind: str) -> Tuple[float, str]:
    """Least time (ms) for a piece of work: the larger of ``nbytes`` over
    the HBM rate and ``ops`` over the peak rate of their dtype ``kind``
    → (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / PEAK_FLOPS[kind] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


@dataclass
class Roofline:
    flops: float                 # per device
    hbm_bytes: float             # per device
    collective_bytes: float      # per device, bottleneck-link model
    n_collectives: int
    by_kind: Dict[str, float]
    hbm_bytes_upper: float = 0.0  # every op's operands and results counted
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        """FLOPs by dtype over each dtype's peak; FLOPs of no stated dtype
        count at the bf16 peak."""
        rest = self.flops - sum(self.flops_by_dtype.values())
        return rest / PEAK_FLOPS["bf16"] + sum(
            n / PEAK_FLOPS[d] for d, n in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def roofline_fraction(self) -> float:
        """dominant term / sum — how close the dominant term is to being the
        ONLY cost (1.0 = perfectly overlapped ideal)."""
        s = self.t_compute + self.t_memory + self.t_collective
        return self.t_bound / s if s else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "flops_by_dtype": dict(self.flops_by_dtype),
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_upper": self.hbm_bytes_upper,
            "collective_bytes": self.collective_bytes,
            "n_collectives": self.n_collectives, "by_kind": self.by_kind,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "bottleneck": self.bottleneck,
        }


def model_flops(param_count_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training; 2·N·D for a forward-only pass (prefill/decode)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * param_count_active * tokens
