"""The program's spans (``repro_torch.tracing``) against a device trace of
the same sub-window, on one clock (Unix ns, the trace's).

:class:`Armed` is a profiled plan (``trace.Scheduled``, device activity
only) with the span recorder armed from its first recorded step to its
last. :func:`reduce` attributes each kernel to the innermost span that was
open on the thread, and at the time, of the runtime call that launched it
(matched by correlation id), and each idle gap of the device to the
innermost span open on the driving thread at the gap's start. It also
reads the spans' own numbers: a request's wait in the queue, the device
reads of a tick and of a gateway call."""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from perfbench.harness import trace as trace_mod

OUTSIDE = "(outside spans)"
PREFIXES = ("engine.", "gateway.", "service.", "train_step.")
# spans emitted from kept stamps: not host work of the thread that emits them
STAMPED = ("engine.queued",)


def _is_span_name(name: str) -> bool:
    return name.startswith(PREFIXES)


def device_activity(prof) -> Tuple[list, dict]:
    """From a finished ``torch.profiler`` run: the device's kernels,
    copies and fills as (start_ns, end_ns, name, correlation ids), and the
    host's runtime calls as {correlation id: (start_ns, the calling
    thread as the trace names it)}, all
    in Unix ns. Ranges the spans opened on the device timeline are left
    out (they are not device work)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, runtime = [], {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            if ev.is_user_annotation() or _is_span_name(name):
                continue
            device.append((ev.start_ns(), ev.end_ns(), name,
                           (ev.correlation_id(), ev.linked_correlation_id())))
        elif ev.correlation_id():
            # a runtime call's resource is the thread that made it: its
            # native id, or its pthread id cut to 32 bits
            runtime[ev.correlation_id()] = (ev.start_ns(),
                                            ev.device_resource_id() & 0xFFFFFFFF)
    return device, runtime


class _Threads:
    """Spans by thread, queried for the innermost span open at a time;
    ``alias`` maps what a runtime call records as its thread, the native
    id or the low 32 bits of the pthread id, to the native id."""

    def __init__(self, spans: Iterable):
        self.by: Dict[int, list] = defaultdict(list)
        self.alias: Dict[int, int] = {}
        for s in spans:
            if s.name in STAMPED:
                continue
            self.by[s.thread].append(s)
            for k in (s.thread, s.ident & 0xFFFFFFFF):
                self.alias.setdefault(k, s.thread)

    def innermost(self, thread: int, times: List[int]) -> list:
        """The innermost span open at each of ``times`` on ``thread`` (a
        sweep over its starts and ends; spans on a thread nest)."""
        spans = self.by.get(thread, [])
        evs = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans)]
                     + [(s.end_ns, 0, i) for i, s in enumerate(spans)])
        order = sorted(range(len(times)), key=times.__getitem__)
        out: list = [None] * len(times)
        open_: List[int] = []
        k = 0
        for q in order:
            t = times[q]
            while k < len(evs) and evs[k][0] <= t:
                _, is_start, i = evs[k]
                if is_start:
                    open_.append(i)
                elif i in open_:
                    open_.remove(i)
                k += 1
            if open_:
                out[q] = spans[max(open_, key=lambda i: (spans[i].start_ns,
                                                         spans[i].span))]
        return out


def _clip(a: int, b: int, t0: int, t1: int) -> int:
    return max(0, min(b, t1) - max(a, t0))


def _gaps(merged, t0: int, t1: int) -> List[Tuple[int, int]]:
    """The device's idle intervals inside [t0, t1]."""
    out, at = [], t0
    for a, b in merged:
        if b <= t0 or a >= t1:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out


def _lead_thread(spans, name: str) -> Optional[int]:
    c = Counter(s.thread for s in spans if s.name == name)
    return c.most_common(1)[0][0] if c else None


def reduce(device: list, runtime: dict, spans: list, t0: int, t1: int,
           lead: str) -> dict:
    """The spans of a sub-window [t0, t1] (Unix ns) against its device
    activity (:func:`device_activity`). ``lead`` names the span whose
    thread drives the device (``engine.tick``, ``train_step.forward``).
    → counts and host seconds by span name; device seconds and launches
    by the innermost span of their runtime call (``kernel_s``,
    ``launches``; a call from a thread that holds no spans counts under
    the driving thread's span at its time, ``foreign_launches``); idle seconds by the driving thread's innermost span at
    the gap's start (``idle_s``); the gateway calls' means (:func:`_calls`);
    ``busy_s`` and ``window_s``; and
    ``metrics``, the numbers the per-layer readers take (None where the
    record holds nothing to read)."""
    win = [s for s in spans if s.end_ns > t0 and s.start_ns < t1]
    n = Counter(s.name for s in win)
    host = defaultdict(float)
    for s in win:
        host[s.name] += _clip(s.start_ns, s.end_ns, t0, t1) / 1e9
    threads = _Threads(spans)

    dev = [d for d in device if d[1] > t0 and d[0] < t1]
    merged = trace_mod.union([(a, b) for a, b, _, _ in dev])
    busy = sum(_clip(a, b, t0, t1) for a, b in merged) / 1e9
    kernel_s, launches = defaultdict(float), Counter()
    calls_by_thread: Dict[int, list] = defaultdict(list)
    main = _lead_thread(spans, lead)
    unmatched = foreign = 0
    lost: Dict[str, float] = defaultdict(float)
    for j, (a, b, name, corrs) in enumerate(dev):
        rt = next((runtime[c] for c in corrs if c in runtime), None)
        th = None if rt is None else threads.alias.get(rt[1], main)
        if th is None:
            unmatched += 1
            lost[name[:60]] += _clip(a, b, t0, t1) / 1e9
            kernel_s[OUTSIDE] += _clip(a, b, t0, t1) / 1e9
            launches[OUTSIDE] += 1
            continue
        # a call from a thread with no spans (autograd's device thread runs
        # the backward's launches) or unnamed: the driving thread's span
        foreign += rt[1] not in threads.alias
        calls_by_thread[th].append((rt[0], j))
    for th, calls in calls_by_thread.items():
        inner = threads.innermost(th, [t for t, _ in calls])
        for (_, j), sp in zip(calls, inner):
            a, b = dev[j][0], dev[j][1]
            name = sp.name if sp is not None else OUTSIDE
            kernel_s[name] += _clip(a, b, t0, t1) / 1e9
            launches[name] += 1

    idle_s: Dict[str, float] = defaultdict(float)
    gaps = _gaps(merged, t0, t1) if dev else []
    if main is not None and gaps:
        for (a, b), sp in zip(gaps, threads.innermost(main, [a for a, _ in gaps])):
            idle_s[sp.name if sp is not None else OUTSIDE] += (b - a) / 1e9

    calls = _calls(spans, t0, t1)
    metrics = {"queue_wait_ms": _queue_wait_ms(win, t0, t1),
               "host_reads_per_tick": _reads_per_tick(win, t0, t1),
               "guard_wait_ms": calls.get("device_read_ms"),
               "host_idle_share": None, "optimizer_share": None,
               "grad_accum_share": None}
    if dev and busy:
        if main is not None and n.get("engine.decode_step"):
            metrics["host_idle_share"] = 100.0 * _idle_outside(
                gaps, [s for s in threads.by[main] if s.name == "engine.decode_step"]) \
                / ((t1 - t0) / 1e9)
        if n.get("train_step.optimizer"):
            metrics["optimizer_share"] = 100.0 * kernel_s["train_step.optimizer"] / busy
        if n.get("train_step.accumulate"):
            metrics["grad_accum_share"] = 100.0 * kernel_s["train_step.accumulate"] / busy
    return {"window_s": (t1 - t0) / 1e9, "busy_s": busy, "n": dict(n),
            "host_s": dict(host), "kernel_s": dict(kernel_s),
            "launches": dict(launches), "idle_s": dict(idle_s), "calls": calls,
            "device_events": len(dev), "unmatched_launches": unmatched,
            "foreign_launches": foreign, "unmatched_top": trace_mod.top(lost, 4),
            "metrics": metrics}


def _idle_outside(gaps, spans) -> float:
    """Seconds of the gaps not covered by ``spans``' intervals."""
    cover = trace_mod.union([(s.start_ns, s.end_ns) for s in spans])
    total = 0
    for a, b in gaps:
        total += b - a - sum(_clip(c, d, a, b) for c, d in cover)
    return total / 1e9


def _queue_wait_ms(spans, t0: int, t1: int) -> Optional[float]:
    """Mean ``engine.queued`` of the requests admitted in [t0, t1]."""
    w = [s.end_ns - s.start_ns for s in spans
         if s.name == "engine.queued" and t0 <= s.end_ns <= t1]
    return sum(w) / len(w) / 1e6 if w else None


def _reads_per_tick(spans, t0: int, t1: int) -> Optional[float]:
    """Mean ``host_reads`` of the ticks in [t0, t1] that ran a step."""
    r = [s.attrs["host_reads"] for s in spans
         if s.name == "engine.tick" and t0 <= s.end_ns <= t1 and s.attrs
         and s.attrs.get("live")]
    return sum(r) / len(r) if r else None


# a gateway call's spans, by the name its mean gets in ``calls``
CALL_PARTS = (("call_ms", "gateway.call"), ("dispatch_ms", "gateway.dispatch"),
              ("handler_ms", "gateway.handler"), ("service_ms", "service.handler"),
              ("submit_ms", "service.submit"))


def _calls(spans, t0: int, t1: int) -> dict:
    """Means over the ``gateway.call`` spans that began in [t0, t1] (a call
    outlasts the sub-window) of each of its spans' time (``CALL_PARTS``) and
    of its device reads (``device_read_ms``): its ``gateway.device_read``
    spans by call id, and the reads with no call id on the thread that
    dispatched it (the transport's own receive-side reads) inside the
    call's span. Empty when no call began in it."""
    calls = {s.call: s for s in spans
             if s.name == "gateway.call" and s.call is not None
             and t0 <= s.start_ns <= t1}
    if not calls:
        return {}
    names = dict((n, k) for k, n in CALL_PARTS)
    part = defaultdict(int)
    disp = {}
    reads = defaultdict(int)
    loose = defaultdict(list)
    for s in spans:
        if s.name == "gateway.device_read":
            if s.call in calls:
                reads[s.call] += s.end_ns - s.start_ns
            elif s.call is None:
                loose[s.thread].append(s)
        elif s.name in names and s.call in calls:
            part[names[s.name]] += s.end_ns - s.start_ns
            if s.name == "gateway.dispatch":
                disp[s.call] = s.thread
    for c, sp in calls.items():
        for s in loose.get(disp.get(c), ()):
            if sp.start_ns <= s.start_ns and s.end_ns <= sp.end_ns:
                reads[c] += s.end_ns - s.start_ns
    n = len(calls)
    out = {"n": n, **{k: part[k] / n / 1e6 for k, _ in CALL_PARTS}}
    out["device_read_ms"] = sum(reads[c] for c in calls) / n / 1e6
    return out


class Armed(trace_mod.Scheduled):
    """A profiled plan of the device's activity alone with the span
    recorder armed over its recorded steps; :meth:`reduce` waits up to
    ``settle_s`` for the spans still open to end (a call begun in the plan
    ends after it), drains them and adds their reduction (:func:`reduce`)
    under ``spans``."""

    def __init__(self, warmup: int, active: int, on_card: bool, lead: str,
                 settle_s: float = 60.0):
        super().__init__(warmup, active, False, on_card)
        self.lead, self.settle_s = lead, settle_s
        self.spans: Optional[list] = None

    def after_step(self) -> bool:
        from repro_torch import tracing
        done = super().after_step()
        if self.steps == self.warmup and not done:
            tracing.arm()
        if done:
            tracing.disarm()
        return done

    def settle(self) -> None:
        """Wait for the spans still open to end, then drain them (once)."""
        import time
        from repro_torch import tracing
        if self.spans is not None:
            return
        end = time.monotonic() + self.settle_s
        while tracing.RECORDER.open_spans() and time.monotonic() < end:
            time.sleep(0.01)
        self.spans = tracing.drain()

    def reduce(self) -> dict:
        from repro_torch import tracing
        self.settle()
        red = super().reduce()
        t0 = int(self.t0 * 1e9) + tracing.RECORDER.offset_ns
        t1 = t0 + int(self.wall_s * 1e9)
        device, runtime = device_activity(self.prof) if self.on_card else ([], {})
        red["spans"] = reduce(device, runtime, self.spans, t0, t1, self.lead)
        return red


def on_cost(block_s: List[float]) -> dict:
    """Blocks timed alternately disarmed and armed (the first disarmed):
    each armed block against the mean of its two disarmed neighbours."""
    off, on = block_s[0::2], block_s[1::2]
    rel = [on[i] / ((off[i] + off[i + 1]) / 2) - 1.0
           for i in range(len(on)) if i + 1 < len(off)]
    rel_sorted = sorted(rel)
    med = rel_sorted[len(rel) // 2] if rel else None
    return {"blocks_s": block_s, "armed_over_disarmed": rel,
            "median": med, "mean_off_s": sum(off) / len(off) if off else None,
            "mean_on_s": sum(on) / len(on) if on else None}


def span_cost_us(n: int = 20000) -> dict:
    """The host's time for one empty span on the calling thread, in µs:
    off, and armed with no profiler on."""
    import time
    from repro_torch import tracing

    def loop() -> float:
        t = time.perf_counter()
        for _ in range(n):
            with tracing.span("span_cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    off = loop()
    tracing.arm()
    try:
        armed = loop()
    finally:
        tracing.disarm()
        tracing.drain()
    return {"off_us": off, "armed_us": armed}
