"""Serving through the north star's path: a closed loop of callers, each
its own ``GatewayClient`` session, calls ``infer`` on the port's
``ServiceGateway("mpklink_opt")`` (regions on the card), whose handler is
``EngineService.handler`` over one ``ServingEngine`` (continuous batching,
greedy decode, ``models.decode_step`` and the kernels).

The benchmark's own instruments sit on the instance, never in the
program: a timing wrapper around the handler; a wrapper on the engine's
``sample`` that counts live slots and each one's cached keys each tick
and copies the last logits of the checked requests into a buffer on the
card.

Set-up makes the weights from the seed on the card, builds the gateway and
the callers' sessions, and runs the traffic until ``warmup_requests``
calls have completed (every shape of the decode step is then warm: the
step has one shape). The window follows. Calls that end in it count.
After it, no call is issued, the checked requests are awaited, the
service is closed, the card's peak is read, the engine's state freed, and
the checked requests' served tokens and captured logits are held against
the float32 reference's forward over the same tokens.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List

import numpy as np

from perfbench.harness import bench, stats, trace as trace_mod, traffic
from perfbench.harness.cell import Outcome, check
from perfbench.harness.model import port_config

GUARD_KERNELS = ("guard_copy", "mac_batch", "mac_init_state", "mac_update",
                 "mac_finalize", "mac_batch_two_pass", "mac_update_two_pass")


class HandlerTimer:
    """The service handler, timed: the seconds of its last call, by the
    thread that ran it (a session's service thread)."""

    def __init__(self, handler):
        self.handler = handler
        self.last: Dict[str, float] = {}

    def __call__(self, req):
        t = time.perf_counter()
        try:
            return self.handler(req)
        finally:
            self.last[threading.current_thread().name] = time.perf_counter() - t

    def pop(self, *threads: str) -> float:
        for name in threads:
            if name in self.last:
                return self.last.pop(name)
        return float("nan")


class Probe:
    """Wraps ``engine.sample`` on the instance: each tick, the live slots,
    the keys each attends (position + 1, from the engine's host cursors:
    ``kv_slots``) and their sum (``kv``), and for the checked requests the
    last logits of every tick that yields one of their tokens, copied into
    ``buf``. Wraps
    ``engine.tick`` too, so that :meth:`profile` can run
    ``torch.profiler`` on the engine's own thread (the profiler records
    the host operators of the thread that starts it)."""

    def __init__(self, engine, requests, check_idx, device):
        import torch
        self.engine = engine
        self.live: List[int] = []
        self.kv: List[int] = []
        self.kv_slots: List[tuple] = []
        self.keys = {(tuple(int(t) for t in requests[i][0]), requests[i][1]): i
                     for i in check_idx}
        self.offset, n = {}, 0
        for i in check_idx:
            self.offset[i] = n
            n += requests[i][1]
        V = engine.cfg.vocab_size
        self.buf = torch.full((n, V), float("nan"), dtype=torch.float32, device=device)
        self._seen: Dict[int, int] = {}
        self._sample = engine.sample
        engine.sample = self.sample
        self._tick = engine.tick
        engine.tick = self.tick
        self._plans: List[tuple] = []       # (warmup, active, host_ops) to run
        self._prof = None
        self._results: List[dict] = []
        self._prof_done = threading.Event()

    def tick(self):
        if self._prof is None and self._plans:
            warmup, active, host_ops = self._plans[0]
            self._prof = trace_mod.Scheduled(warmup, active, host_ops,
                                             self.engine.device.type == "cuda")
            self._mark = None
        out = self._tick()
        p = self._prof
        if p is not None:
            if p.steps == p.warmup - 1:     # the next tick is the first recorded
                self._mark = (len(self.live), self.engine.ticks)
            if p.after_step():
                n0, k0 = self._mark
                self._results.append({"prof": p, "ticks": self.engine.ticks - k0,
                                      "live": self.live[n0:], "kv": self.kv[n0:]})
                self._plans.pop(0)
                self._prof = None
                if not self._plans:
                    self._prof_done.set()
        return out

    def profile(self, plans, timeout: float) -> List[dict]:
        """Profile the coming ticks on the engine's thread, one
        ``(warmup, active, host_ops)`` plan after another; → each plan's
        reduced trace with its recorded ticks' counters."""
        self._plans = list(plans)
        if not self._prof_done.wait(timeout):
            raise RuntimeError(f"the engine did not finish its profiled ticks in {timeout} s")
        out = []
        for r in self._results:
            red = r.pop("prof").reduce()
            red.update(r)
            out.append(red)
        return out

    def sample(self, last):
        out = self._sample(last)
        eng = self.engine
        slots = []
        for b, req in enumerate(eng.slots):
            if req is None:
                continue
            cur, g = int(eng.prompt_cursor[b]), len(req.generated)
            slots.append(cur + g)
            i = self._seen.get(req.rid)
            if i is None:
                i = self._seen[req.rid] = self.keys.get(
                    (tuple(int(t) for t in req.prompt), req.max_new), -1)
            if i >= 0 and cur >= len(req.prompt):
                self.buf[self.offset[i] + g].copy_(last[b])
        self.live.append(len(slots))
        self.kv.append(sum(slots))
        self.kv_slots.append(tuple(slots))     # a tuple of ints: no garbage collector work
        return out


class ClosedLoop:
    """``len(clients)`` callers; each sends the next request of the list as
    soon as its previous call returns. Once ``stop`` is set, a caller sends
    no request past the last of ``keep`` (the checked ones are all sent)."""

    def __init__(self, clients, requests, timer, keep):
        self.clients, self.requests, self.timer = clients, requests, timer
        self.keep = set(keep)                 # indices whose tokens are kept
        self.last_kept = max(keep)
        self.records: List[dict] = []
        self.tokens: Dict[int, np.ndarray] = {}
        self.errors: List[str] = []
        self._next = itertools.count()
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self.stop = threading.Event()
        self.exhausted = False
        self._threads = [threading.Thread(target=self._caller, args=(i,),
                                          name=f"caller-{i}", daemon=True)
                         for i in range(len(clients))]

    def start(self):
        for t in self._threads:
            t.start()

    def _caller(self, i: int):
        from repro_torch.runtime import encode_prompt
        client = self.clients[i]
        while True:
            with self._lock:
                k = next(self._next)
            if self.stop.is_set() and k > self.last_kept:
                return
            if k >= len(self.requests):
                self.exhausted = True
                return
            prompt, max_new = self.requests[k]
            payload = encode_prompt(prompt.tolist(), max_new)
            t0 = time.perf_counter()
            try:
                out = client.call("infer", payload).cpu().numpy()
                err = None
            except Exception as e:          # a failed call is counted, not raised
                out, err = None, f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
            session = client._session_obj
            handler_s = self.timer.pop(
                getattr(getattr(session, "_thread", None), "name", ""),
                threading.current_thread().name)
            ok = err is None and out.shape == (max_new,)
            rec = {"k": k, "t_start": t0, "t_end": t1, "ok": ok,
                   "n_out": int(out.shape[0]) if out is not None else 0,
                   "handler_s": handler_s}
            with self._lock:
                if err is not None and not self.stop.is_set():
                    self.errors.append(err)
                if k in self.keep and out is not None:
                    self.tokens[k] = out
                self.records.append(rec)
                self._done.notify_all()

    def wait(self, pred, timeout: float) -> bool:
        with self._lock:
            return self._done.wait_for(lambda: pred(self), timeout=timeout)

    def join(self, timeout: float):
        """Wait up to ``timeout`` in all; → the callers still running."""
        end = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, end - time.monotonic()))
        return [t.name for t in self._threads if t.is_alive()]


def shut(svc, loop: ClosedLoop, patience: float = 60.0) -> list:
    """Close the service and wait for every caller to end. The service's
    handler checks for a close and registers its request under one hold of
    the lock that ``close`` takes, so one ``close`` releases every call;
    the loop closes again while callers remain, an idempotent guard that
    bounds the wait. → the callers still running after ``patience``
    seconds."""
    end = time.monotonic() + patience
    while True:
        svc.close()
        stuck = loop.join(timeout=0.2)
        if not stuck or time.monotonic() > end:
            return stuck


def _window_counters(engine, probe, ops) -> dict:
    launches = ops.LAUNCHES.snapshot()
    return {"ticks": engine.ticks, "n_tick": len(probe.live),
            "guard": sum(launches.get(k, 0) for k in GUARD_KERNELS),
            "t": time.perf_counter()}


def run(ctx) -> Outcome:
    import torch
    from repro_torch.core import ServiceGateway
    from repro_torch.kernels import _build, ops
    from repro_torch.runtime import EngineService, ServingEngine

    cfg, mix = ctx.cell.config, ctx.cell.traffic
    fam = bench.reference_module(cfg["family"], ctx.cell.root)
    dev = ctx.device
    on_card = dev.type == "cuda"
    if on_card:
        _build.build()
        torch.cuda.reset_peak_memory_stats(dev)
    marks = {"build": time.perf_counter() - ctx.t_start}
    dtype = getattr(torch, cfg["dtype"])
    elem = torch.empty((), dtype=dtype).element_size()
    params = fam.make_params(cfg, ctx.seed, dtype, dev)
    if on_card:
        torch.cuda.synchronize(dev)
    marks["weights"] = time.perf_counter() - ctx.t_start
    requests = traffic.serve_requests(mix, ctx.seed, cfg["vocab_size"], mix["pool"])
    check_idx = traffic.check_sample(mix, ctx.seed, requests)

    engine = ServingEngine(port_config(cfg), params, max_batch=mix["max_batch"],
                           max_seq=mix["max_seq"], dtype=dtype, device=dev,
                           greedy=True, seed=ctx.seed & traffic.SEED_MASK)
    probe = Probe(engine, requests, check_idx, dev)
    svc = EngineService(engine, timeout=mix["call_timeout_s"]).start()
    timer = HandlerTimer(svc.handler)
    gw = ServiceGateway("mpklink_opt", max_keys=4 * mix["callers"] + 64, device=dev,
                        transport_kwargs={"timeout": mix["call_timeout_s"]})
    gw.register_service("infer", timer)
    gw.start()
    clients = [gw.connect(f"caller-{i}") for i in range(mix["callers"])]
    for c in clients:
        c.open("infer")
    loop = ClosedLoop(clients, requests, timer, check_idx)
    marks["gateway"] = time.perf_counter() - ctx.t_start
    prof_out = None
    try:
        loop.start()
        if not loop.wait(lambda lp: len(lp.records) >= mix["warmup_requests"],
                         timeout=mix["warmup_timeout_s"]):
            raise RuntimeError(f"warm-up: {len(loop.records)} calls completed in "
                               f"{mix['warmup_timeout_s']} s; errors {loop.errors[:3]}")
        if on_card:
            torch.cuda.synchronize(dev)
        c0 = _window_counters(engine, probe, ops)
        t0 = c0["t"]
        setup_s = t0 - ctx.t_start
        t1 = t0 + ctx.seconds
        time.sleep(max(0.0, t1 - time.perf_counter()))
        c1 = _window_counters(engine, probe, ops)
        t1 = c1["t"]
        if ctx.trace:           # a steady sub-window right after the window
            # the device's activity alone, then the host's operators too
            # (which slow the tick) for the device time under them
            dev_only, with_ops = probe.profile(
                [(mix["profile_warmup"], mix["profile_ticks"], False),
                 (mix["profile_warmup"], mix["profile_ops_ticks"], True)],
                mix["call_timeout_s"])
            prof_out = {**dev_only, "ops": with_ops}
        loop.stop.set()
        waited = loop.wait(lambda lp: all(i in lp.tokens for i in check_idx),
                           timeout=mix["check_wait_s"])
    finally:
        loop.stop.set()
        stuck = shut(svc, loop)
        for c in clients:
            c.close()
        gw.close()
    if stuck:
        raise RuntimeError(f"caller threads did not end: {stuck[:4]}")
    if loop.exhausted:
        raise RuntimeError("the request pool ran out before the window closed")

    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    verified = sum(c.macs_verified for c in clients)
    del engine.state, svc, gw, clients
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    win = stats.serve_window(loop.records, t0, t1)
    done = stats.in_window(loop.records, t0, t1)
    answered = [r for r in done if r["ok"]]
    lo, hi = c0["n_tick"], c1["n_tick"]
    rec = {"mode": "serve", "config": cfg, "traffic": mix, "elem": elem,
           "window_s": t1 - t0, "ticks": c1["ticks"] - c0["ticks"],
           "live": probe.live[lo:hi], "kv": probe.kv[lo:hi],
           "kv_slots": probe.kv_slots[lo:hi],
           "answered": len(answered), "output_tokens": win["output_tokens"],
           "gateway_s": sum(r["t_end"] - r["t_start"] - r["handler_s"]
                            for r in answered),
           "guard_launches": c1["guard"] - c0["guard"], "peak_bytes": peak,
           "trace": prof_out, "setup_marks_s": marks}

    # correctness: every call that ended answered in full with a verified
    # frame; the checked requests' tokens and logits against the reference
    all_ok = [r for r in loop.records if r["ok"]]
    checks = {"failed_calls": check(win["failed"], 0),
              "unverified_responses": check(len(all_ok) - min(verified, len(all_ok)), 0),
              "checked_requests_missing": check(0 if waited else
                                                len(set(check_idx) - set(loop.tokens)), 0)}
    readings, control = _compare(cfg, fam, params, requests, check_idx, loop.tokens,
                                 probe, dev, mix["check_router_margin"],
                                 mix["check_window"], ctx.calibrate)
    del engine.sample, engine.tick          # the probe's wrappers: no cycle holds the weights
    for name, limit in ctx.cell.limits.items():
        checks[name] = check(readings.get(name, float("inf")), limit)
    e2e = {"request_p95_ms": win["request_p95_ms"]}
    out = Outcome(setup_s=setup_s, e2e=e2e, attempted=win["attempted"],
                  failed=win["failed"], checks=checks, rec=rec, peak_bytes=peak,
                  control={"program": readings, "control": control} if ctx.calibrate else {})
    if prof_out is not None:
        out.busy_s, out.window_s = prof_out["busy_s"], prof_out["wall_s"]
        out.breakdown = {"device_ops": trace_mod.top(prof_out["kernels"]),
                         "idle_gaps": trace_mod.top(prof_out["idle_by_host"])}
    return out


def row_stats(got, ref, tokens, margin) -> dict:
    """Per position of one request: the largest and the root-mean-square
    logit error of ``got`` against the reference's ``ref`` (rows, V), the
    gap by which the reference's logit of ``tokens`` lies below its best,
    and the reference's router margin there (+inf without a router)."""
    d = got - ref
    best = ref.max(-1).values
    return {"max_err": d.abs().max(-1).values, "rms_err": d.square().mean(-1).sqrt(),
            "gap": best - ref.gather(1, tokens[:, None])[:, 0], "margin": margin}


def summarize(rows: list, tau: float, window: int) -> dict:
    """The numbers a run compares from the per-position readings of its
    checked requests (one row dict a request, positions in order).

    Only the positions whose router margin is at least ``tau`` are held,
    and each number is the largest, over every run of ``window``
    consecutive held positions of one request, of the run's median: a
    bf16 router picks another expert than the reference's at some near
    ties even above ``tau``, and the median passes over such single
    positions, not over a fault that spans a run of them (a slot, a stretch
    of the cache). ``gap_win_clear`` is the median gap by which the served
    tokens lie below the reference's best, ``err_win_clear`` the median
    RMS logit error. Beside them ``uncaptured``, the positions whose
    logits were never captured, and, for the calibration, the share of
    positions left out and their count."""
    import torch
    out = {"gap_win_clear": 0.0, "err_win_clear": 0.0, "uncaptured": 0,
           "windows": 0}
    n = held = 0
    for r in rows:
        clear = r["margin"] >= tau
        n += int(clear.numel())
        held += int(clear.sum())
        out["uncaptured"] += int(torch.isnan(r["max_err"]).sum())
        if int(clear.sum()) < window:
            continue
        for key, name in (("gap", "gap_win_clear"), ("rms_err", "err_win_clear")):
            runs = r[key][clear].double().nan_to_num(nan=float("inf")).unfold(0, window, 1)
            out[name] = max(out[name], float(torch.quantile(runs, 0.5, dim=-1).max()))
        out["windows"] += int(clear.sum()) - window + 1
    if not out["windows"]:          # nothing held: nothing shown correct
        out["gap_win_clear"] = out["err_win_clear"] = float("inf")
    out["flagged_share"] = 1.0 - held / max(n, 1)
    out["n_positions"] = n
    return out


def positions(rows: list) -> dict:
    """Every checked position's readings, rounded, for the calibration's
    look at where the large ones sit."""
    import torch
    return {key: [round(float(v), 5) for v in torch.cat([r[key] for r in rows])]
            for key in ("margin", "gap", "max_err", "rms_err")}


def _compare(cfg, fam, params, requests, check_idx, tokens, probe, dev,
             tau: float, window: int, calibrate: bool):
    """The checked requests' numbers (``summarize``) against the float32
    reference's forward over prompt + served tokens, with the reference's
    router margins. With ``calibrate``, the same numbers of the control,
    the reference in float8 in the program's place (the token it puts
    first, its logits), and every position's readings of both."""
    import torch
    from perfbench.reference import common
    common.exact_f32()
    have = [i for i in check_idx if i in tokens]
    if not have:
        return {}, {}
    seqs, starts, served = [], [], []
    for i in have:
        prompt, gen = requests[i][0], tokens[i]
        seq = np.concatenate([prompt, gen[:-1]]).astype(np.int64)
        seqs.append(torch.from_numpy(seq).to(dev))
        starts.append(len(prompt) - 1)
        served.append(torch.from_numpy(gen.astype(np.int64)).to(dev))
    prog_rows, ctl_rows = [], []
    with torch.no_grad():
        margins: list = []
        ref = fam.logits(cfg, params, seqs, starts, "f32", margins=margins)
        ctl = fam.logits(cfg, params, seqs, starts, "fp8") if calibrate else None
        for j, i in enumerate(have):
            o = probe.offset[i]
            r = ref[j]
            m = margins[j] if margins else torch.full((r.shape[0],), float("inf"),
                                                     device=r.device)
            prog_rows.append(row_stats(probe.buf[o:o + r.shape[0]], r, served[j], m))
            if ctl is not None:
                ctl_rows.append(row_stats(ctl[j], r, ctl[j].argmax(-1), m))
    prog = summarize(prog_rows, tau, window)
    control = {}
    if calibrate:
        control = summarize(ctl_rows, tau, window)
        control["positions"] = {"program": positions(prog_rows),
                                "control": positions(ctl_rows)}
    return prog, control
