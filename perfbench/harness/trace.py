"""Reduction of a ``torch.profiler`` trace of a steady sub-window to the
numbers the per-layer readers take: the device's busy time (the union of
its kernel, copy and fill intervals), kernel time by name and by family,
device time under chosen host operators, and idle time by what the host
was doing when the device went idle."""
from __future__ import annotations

import bisect
import re
import time
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

# kernel families by name (case-insensitive), first match wins; the
# benchmark's own table (the port keeps none)
FAMILIES = (
    ("flash_attention_bwd", r"flash_bwd"),
    ("flash_attention", r"flash_fwd"),
    ("decode_attention", r"decode_(fused|split|merge)"),
    ("guard", r"guard_copy|mac_"),
    ("ssd_scan_bwd", r"ssd_bwd|ssd_dstate_pass|ssd_states_mma<true>"),
    ("ssd_scan", r"ssd_states_mma|ssd_state_pass|ssd_output_mma"),
    ("gemm", r"gemm|nvjet|xmma|cutlass|cublas|sm90_"),
    ("softmax_cross_entropy", r"softmax|nll_loss|cross_entropy"),
    ("reduce", r"reduce|norm"),
    ("copy_cat_memcpy", r"copy|memcpy|cat"),
    ("elementwise", r"elementwise|index|gather|scatter|fill|memset"),
)


def family(name: str) -> str:
    return next((f for f, pat in FAMILIES if re.search(pat, name, re.I)), "other")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _device_type(e):
    return getattr(e, "device_type", None)


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("train_step.")


def reduce_profile(prof, host_ops=("aten::bmm",)) -> dict:
    """→ {"busy_s", "kernels" {name: s}, "families" {family: s},
    "host_op_device_s" {op: s} for ``host_ops``, "idle_by_host" {op: s}}."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    kernels: Dict[str, float] = defaultdict(float)
    for e in prof.events():
        tr = e.time_range
        if _device_type(e) == cuda:
            if _annotation(e):          # a record_function range, not device work
                continue
            dev.append((tr.start, tr.end))
            kernels[e.name[:120]] += (tr.end - tr.start) / 1e6
        else:
            cpu.append(e)
    merged = union(dev)
    busy = sum(b - a for a, b in merged) / 1e6
    fams: Dict[str, float] = defaultdict(float)
    for name, s in kernels.items():
        fams[family(name)] += s
    host_dev = {}
    for e in prof.key_averages():
        if e.key in host_ops:
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            host_dev[e.key] = t / 1e6
    return {"busy_s": busy, "kernels": dict(kernels), "families": dict(fams),
            "host_op_device_s": host_dev, "idle_by_host": _idle_by_host(merged, cpu)}


def _idle_by_host(merged, cpu_events) -> Dict[str, float]:
    """Idle device time between merged intervals, by the innermost host
    operator running at the gap's start on the thread that ran the most
    operators (the one that drives the device)."""
    if len(merged) < 2 or not cpu_events:
        return {}
    main = Counter(e.thread for e in cpu_events).most_common(1)[0][0]
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in cpu_events if e.thread == main)
    starts = [o[0] for o in ops]
    out: Dict[str, float] = defaultdict(float)
    for (_, b), (a2, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(starts, b) - 1
        name = "(host between operators)"
        for j in range(i, max(-1, i - 64), -1):
            if ops[j][1] > b:
                name = ops[j][2]
                break
        out[name[:120]] += (a2 - b) / 1e6
    return dict(out)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` largest entries as [name, seconds] pairs."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Scheduled:
    """``torch.profiler`` over ``active`` steps after ``warmup`` unrecorded
    ones (which absorb the profiler's own start-up), driven from the thread
    that runs the steps: call :meth:`after_step` after each step. With
    ``host_ops`` the host operators of that thread are recorded too, at a
    cost to its speed; without, only the device's activity and the CUDA
    runtime's calls. ``wall_s`` is the host time of the recorded steps,
    closed by a synchronise."""

    def __init__(self, warmup: int, active: int, host_ops: bool, on_card: bool):
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = ([ProfilerActivity.CPU] if host_ops or not on_card else []) \
            + ([ProfilerActivity.CUDA] if on_card else [])
        self.on_card, self.warmup, self.active = on_card, warmup, active
        self.prof = profile(activities=acts, schedule=schedule(
            wait=0, warmup=warmup, active=active, repeat=1))
        self.steps, self.t0, self.wall_s = 0, None, None
        self.prof.start()

    def after_step(self) -> bool:
        """Count one step; → True once the recorded steps are done (the
        profiler is then stopped)."""
        self.steps += 1
        if self.steps == self.warmup + self.active:
            if self.on_card:
                import torch
                torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - self.t0
        self.prof.step()
        if self.steps == self.warmup:
            self.t0 = time.perf_counter()
        if self.wall_s is not None:
            self.prof.stop()
            return True
        return False

    def reduce(self) -> dict:
        red = reduce_profile(self.prof)
        red.update(wall_s=self.wall_s, steps=self.active)
        return red
