"""Training through ``runtime.steps.make_train_step``, as the port's
``Trainer`` runs it: the benchmark's weights (float32 parameters, made
from the seed on the card), the port's AdamW state, bf16 compute, the
mix's microbatches and remat.

Set-up builds the one step object and its state and drives it through its
first ``checked_steps`` steps on batches whose rows all differ; they warm
every shape, and what they leave is kept for the check: each step's loss,
the gradient of the first step as the optimizer got it (its first moment
over 1 − β1, unclipped with the step's own norm) and each leaf's change
after the last of them (the starting weights drawn again from the seed,
leaf by leaf; kept in float32 in host memory). The window then runs steps
until its time is up, and is closed by a synchronise after the last one.
After it, the card's peak is read, the program's state freed, and the
plain float32 reference follows the same checked steps from the same
weights and batches.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.harness import bench, stats, trace as trace_mod, traffic
from perfbench.harness.cell import Outcome, check
from perfbench.harness.model import port_config


def _norms(tree) -> dict:
    import torch
    from perfbench.reference.common import walk
    return {p: float(torch.linalg.vector_norm(t.float())) for p, t in walk(tree)}


def _deltas(tree, specs, seed, dev) -> dict:
    """Each leaf's change from its starting weights (drawn again), in
    float32 in host memory."""
    import torch
    from perfbench.reference.common import make_leaf
    out = {}
    for i, spec in enumerate(specs):
        t = tree
        for k in spec[0]:
            t = t[k]
        d = make_leaf(spec, seed, i, t.dtype, dev).float()
        out[spec[0]] = d.neg_().add_(t.float()).cpu()
        del d
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(ctx) -> Outcome:
    import torch
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.models import Impl
    from repro_torch.optim import init_opt_state
    from repro_torch.runtime.steps import make_train_step
    from perfbench.reference import common

    cfg, mix = ctx.cell.config, ctx.cell.traffic
    fam = bench.reference_module(cfg["family"], ctx.cell.root)
    dev = ctx.device
    on_card = dev.type == "cuda"
    if on_card:
        _build.build()
        torch.cuda.reset_peak_memory_stats(dev)
    marks = {"build": time.perf_counter() - ctx.t_start}
    pdt = getattr(torch, cfg["train_param_dtype"])
    specs = fam.leaf_specs(cfg)
    params = common.make_tree(specs, ctx.seed, pdt, dev)
    opt_cfg = dict(mix["optimizer"])
    opt = init_opt_state(params, dtype=getattr(torch, cfg["train_opt_dtype"]))
    tcfg = TrainConfig(microbatch_size=mix["micro"], dtype=cfg["train_compute_dtype"],
                       param_dtype=cfg["train_param_dtype"],
                       optimizer=OptimizerConfig(**opt_cfg))
    step = make_train_step(port_config(cfg), tcfg, Impl(remat=bool(mix["remat"])))
    toks = traffic.train_tokens(mix, ctx.seed, cfg["vocab_size"], mix["batches"])
    batches = [{"tokens": t, "labels": t}
               for t in torch.from_numpy(toks).to(dev).unbind(0)]
    B, S = mix["global_batch"], mix["seq_len"]
    n_check = mix["checked_steps"]
    if on_card:
        torch.cuda.synchronize(dev)
    marks["weights"] = time.perf_counter() - ctx.t_start

    # set-up: the checked steps, through the window's own call and feed
    losses, grad_prog = [], None
    for s in range(n_check):
        params, opt, met = step(params, opt, batches[s])
        losses.append(float(met["loss"]))
        if s == 0:
            gn = float(met["grad_norm"])
            scale = min(1.0, opt_cfg["grad_clip"] / max(gn, 1e-12))
            grad_prog = {p: n / (1 - opt_cfg["b1"]) / scale
                         for p, n in _norms(opt["m"]).items()}
    marks["checked_steps"] = time.perf_counter() - ctx.t_start
    delta_prog = _deltas(params, specs, ctx.seed, dev)
    for s in range(mix["warm_steps"]):
        params, opt, _ = step(params, opt, batches[(n_check + s) % len(batches)])
    if on_card:
        torch.cuda.synchronize(dev)

    # the window
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    t1, k = t0 + ctx.seconds, 0
    first = n_check + mix["warm_steps"]
    while time.perf_counter() < t1:
        params, opt, _ = step(params, opt, batches[(first + k) % len(batches)])
        k += 1
    if on_card:
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    rate = stats.train_rate(B * S, k, t0, t_end)

    prof_out = None
    if ctx.trace:
        prof_out = _profile(step, params, opt, batches, first + k,
                            mix["profile_warmup"], mix["profile_steps"], ops, on_card)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    del params, opt, step, batches
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    elem = torch.empty((), dtype=getattr(torch, cfg["train_compute_dtype"])).element_size()
    rec = {"mode": "train", "config": cfg, "traffic": mix, "elem": elem,
           "window_s": t_end - t0, "steps": k, "tokens_per_step": B * S,
           "peak_bytes": peak, "trace": prof_out, "setup_marks_s": marks}
    ref = reference_steps(fam, cfg, specs, ctx.seed, dev, toks[:n_check], opt_cfg, "f32")
    prog = {"loss": losses, "grad": grad_prog, "delta": delta_prog}
    at = (specs, ctx.seed, dev, opt_cfg)
    readings, leaves = compare(prog, ref, *at)
    checks = {name: check(v, ctx.cell.limits[name]) for name, v in readings.items()}
    control = {}
    if ctx.calibrate:
        ctl = reference_steps(fam, cfg, specs, ctx.seed, dev, toks[:n_check],
                              opt_cfg, "fp8")
        control["fp8"], ctl_leaves = compare(ctl, ref, *at)
        control["leaves"] = {"program": leaves, "fp8": ctl_leaves}
        del ctl
        half = reference_steps(fam, cfg, specs, ctx.seed, dev,
                               toks[:n_check, :B // 2], opt_cfg, "f32")
        control["half_batch"] = compare(half, ref, *at)[0]
        del half
        for fault in PLANTED:
            control[fault] = compare(ref, ref, *at, plant=fault)[0]
    out = Outcome(setup_s=setup_s, e2e={"train_tokens_per_s": rate}, attempted=k,
                  failed=0, checks=checks, rec=rec, peak_bytes=peak, control=control)
    if prof_out is not None:
        out.busy_s, out.window_s = prof_out["busy_s"], prof_out["wall_s"]
        out.breakdown = {"device_ops": trace_mod.top(prof_out["kernels"]),
                         "idle_gaps": trace_mod.top(prof_out["idle_by_host"])}
    return out


def _profile(step, params, opt, batches, first: int, warmup: int, n: int, ops,
             on_card) -> dict:
    """``torch.profiler`` over ``n`` more steps after the window (after
    ``warmup`` unrecorded ones), with the flash-attention launches of the
    recorded steps."""
    prof = trace_mod.Scheduled(warmup, n, True, on_card)
    j, l0 = 0, None
    while True:
        if prof.steps == warmup:
            l0 = ops.LAUNCHES.snapshot()
        params, opt, _ = step(params, opt, batches[(first + j) % len(batches)])
        j += 1
        if prof.after_step():
            break
    l1 = ops.LAUNCHES.snapshot()
    red = prof.reduce()
    red["launches"] = {k: l1[k] - l0[k] for k in l1 if l1[k] != l0[k]}
    return red


PLANTED = ("no_decay", "swap_kv")
KV = (("blocks", "attn", "wk"), ("blocks", "attn", "wv"))


def _planted(fault, path, d_ref, p0, ref, dev, decay):
    """A leaf's change under a fault planted in the reference's result:
    ``no_decay``, the update without its weight decay (Σ lr·wd·p added
    back, p at its start: it moves by under 1e-4 of itself in the checked
    steps); ``swap_kv``, the key and value projections' updates written
    each into the other's leaf."""
    if fault == "no_decay":
        return d_ref + decay * p0 if p0.ndim > 1 else d_ref
    if fault == "swap_kv" and path in KV:
        return ref["delta"][KV[1 - KV.index(path)]].to(dev)
    return d_ref


def _leaf_readings(got, ref, specs, seed, dev, opt, plant=None) -> dict:
    """Per leaf, on the card one at a time: (‖Δ_ref‖, ‖Δ‖, ‖Δ − Δ_ref‖,
    the decay reading or None). The decay reading of a leaf that decays
    (more than one dimension) is |⟨Δ − Δ_ref, p0⟩| over the decay's own
    share of ⟨Δ_ref, p0⟩ in the checked steps, wd · Σ lr · ‖p0‖²: an
    update without its decay reads 1."""
    import torch
    from perfbench.reference import adamw
    from perfbench.reference.common import make_leaf
    n_steps = len(ref["loss"])
    decay = opt["weight_decay"] * sum(adamw.lr_at(s, opt) for s in range(1, n_steps + 1))
    out = {}
    for i, spec in enumerate(specs):
        path = spec[0]
        d_ref = ref["delta"][path].to(dev)
        p0 = make_leaf(spec, seed, i, torch.float32, dev)
        d = (_planted(plant, path, d_ref, p0, ref, dev, decay) if plant
             else got["delta"][path].to(dev))
        diff = d - d_ref
        dec = None
        if p0.ndim > 1:
            dec = abs(float(torch.dot(diff.flatten(), p0.flatten()))) \
                / (decay * float(p0.square().sum()))
        out[path] = tuple(float(torch.linalg.vector_norm(t)) for t in (d_ref, d, diff)) \
            + (dec,)
        del d_ref, p0, d, diff
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(got: dict, ref: dict, specs, seed, dev, opt: dict, plant=None):
    """The numbers held against their limits, → (numbers, per-leaf
    readings): ``loss_rel``, the worst step's |loss − reference's| over the
    reference's; ``grad_leaf``, the worst leaf's gap between the first
    gradient's norms; over the leaves whose reference gradient is at least
    a thousandth of the median leaf's (the others move by round-off
    alone), ``change_leaf``, the worst leaf's gap between the norms of the
    change after the checked steps, ``change_dir``, the worst leaf's norm
    of the difference of the changes (each over the larger of the
    reference's norm of that leaf and of the median leaf), and
    ``decay_leaf``, the worst decay reading (``_leaf_readings``). With
    ``plant``, ``got`` is the reference's result with that fault planted."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    gmed = float(np.median(list(ref["grad"].values())))
    moved = [p for p, n in ref["grad"].items() if n >= 1e-3 * gmed]
    lv = _leaf_readings(got, ref, specs, seed, dev, opt, plant)
    cmed = float(np.median([lv[p][0] for p in moved]))
    per = {p: {"grad": abs(got["grad"][p] - ref["grad"][p]) / max(ref["grad"][p], gmed),
               "change": abs(lv[p][1] - lv[p][0]) / max(lv[p][0], cmed),
               "dir": lv[p][2] / max(lv[p][0], cmed), "decay": lv[p][3],
               "grad_over_median": ref["grad"][p] / gmed}
           for p in ref["grad"]}
    numbers = {"loss_rel": loss,
               "grad_leaf": max(per[p]["grad"] for p in per),
               "change_leaf": max(per[p]["change"] for p in moved),
               "change_dir": max(per[p]["dir"] for p in moved),
               "decay_leaf": max(per[p]["decay"] for p in moved
                                 if per[p]["decay"] is not None)}
    return ({k: worst_of(v) for k, v in numbers.items()},
            {".".join(p): v for p, v in per.items()})


def worst_of(x: float) -> float:
    return float("inf") if x != x else float(x)


def reference_steps(fam, cfg, specs, seed, dev, toks, opt: dict, precision: str) -> dict:
    """The plain reference's training from the same weights over the same
    batches (rows one at a time), with its own AdamW: each step's loss, the
    first step's gradient norms by leaf, each leaf's change after the last
    (``_deltas``)."""
    import torch
    from perfbench.reference import adamw, common
    common.exact_f32()
    tree = common.make_tree(specs, seed, torch.float32, dev)
    paths = [p for p, _ in common.walk(tree)]
    flat = [t for _, t in common.walk(tree)]
    for t in flat:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for t in flat]
    v = [torch.zeros_like(t) for t in flat]
    losses, grad = [], None
    for s, batch in enumerate(toks, start=1):
        total = 0.0
        for row in torch.from_numpy(batch).to(dev):
            loss = fam.row_loss(cfg, tree, row, precision) / batch.shape[0]
            loss.backward()
            total += loss.item()
        losses.append(total)
        grads = [t.grad for t in flat]
        if s == 1:
            grad = {p: float(torch.linalg.vector_norm(g)) for p, g in zip(paths, grads)}
        adamw.step([t.data for t in flat], grads, m, v, s, opt)
        for t in flat:
            t.grad = None
    del m, v, grads
    for t in flat:
        t.requires_grad_(False)
    delta = _deltas(tree, specs, seed, dev)
    del tree, flat
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "grad": grad, "delta": delta}
