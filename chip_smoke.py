#!/usr/bin/env python3
"""The PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. card    — name and power limit (nvidia-smi), and the build of every
             CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per
             source, in parallel).
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main paths' shapes and at edge cases (guard MACs bit-exact,
             each call twice after a many-chunk call; decode and flash
             attention at 2e-5 in f32 and 2e-2 in bf16, decode each call
             twice, with fully masked splits, one split, the long cache;
             the SSD scan at 1e-4 in f32 and 2e-2 in bf16, relative and
             absolute, with mamba2-1.3b's decays).
3. prefill — ``runtime.steps.make_prefill_step`` at full width and depth
             (bf16, random weights from a seeded generator), 4 prompts of
             2048 tokens, for llama3.2-1b and mamba2-1.3b: ms per prefill,
             prompt tokens/s, peak memory, finite logits; the launch counts
             are zeroed just before and read just after (16 flash-attention
             launches per llama call, 48 SSD-scan launches per mamba2 call).
4. serve   — llama3.2-1b at full width and depth (bf16), max_batch 8,
             max_seq 1024: 12 concurrent lockstep clients and one batch
             envelope of 8; then mamba2-1.3b the same way with 8 clients.
             Every request and response is a sealed frame through the
             service step; a tampered frame must be refused. The launch
             counts are zeroed just before and read just after; each kernel
             of the path must be > 0.
5. parity  — in f32 at full width: the llama engine with the decode-attention
             kernel and with its plain version give identical greedy tokens;
             the reduced engine on the card equals it on the CPU; and for
             both families the forward with the kernels equals the forward
             with the plain versions, and the last prefill logits equal
             ``decode_step`` run token by token over the same prompt
             (identical argmax, max abs difference printed).

Then a ``kernels`` JSON line (times from CUDA events, bounds from this
run's inputs, launches summed over the prefill and serve phases; the flash
and SSD rows add ``earlier_ms``, the CUDA-core design they replaced timed
in this run, ``kernels_per_call``, the SSD's ``pass_ms`` and
``tensor_core_instr``, the HGMMA/HMMA instructions in the SASS of their
bf16 kernels; the decode-attention and guard_copy rows add ``earlier_ms``
and ``earlier_graph_ms``, the two-launch designs they replaced, ``graph_ms``,
ms per call under CUDA-graph replay (outputs checked against the eager
calls bit for bit), and ``kernels_per_call`` from ``torch.profiler``
(must be 1); decode attention adds ``at_full_cache``, 16 layer caches of
(8, 1024, 8, 64) called in turn, and ``at_long_cache``, one (8, 16384, 8,
64) cache, both cold in L2; guard_copy adds ``at_64MiB``), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device": {...}}``.
Imports neither JAX nor the ``repro`` package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}   # dense tensor-core bf16; f32 non-tensor
SEED = 0x5EED1234
SRC = "src/repro_torch/kernels/csrc"


def emit(**rec):
    print(json.dumps(rec), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters):
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, reps=10):
    """Capture ``calls`` (functions of no argument, one kernel call each) in
    one CUDA graph after an eager warm-up on the capture stream (which makes
    the kernels' workspaces), replay it ``reps`` times between CUDA events,
    and check that the replay's outputs equal the eager ones bit for bit.
    → ms per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [fn() for fn in calls]
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [fn() for fn in calls]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    for want, got in zip(eager, outs):
        for w, g in zip(*(x if isinstance(x, tuple) else (x,) for x in (want, got))):
            check(torch.equal(w.view(torch.int32) if w.dtype == torch.uint32 else w,
                              g.view(torch.int32) if g.dtype == torch.uint32 else g),
                  "a CUDA graph replay differs from the eager call")
    del graph, outs
    return start.elapsed_time(end) / (reps * len(calls))


def kernels_per_call(fn, n=10):
    """Device kernels per call of ``fn``, counted by ``torch.profiler`` over
    ``n`` calls (copies and memsets aside)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset")))
    return kernels / n


def bound(nbytes, ops, kind):
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    from repro_torch.kernels import _build
    build_s = _build.build()
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         build_s=round(build_s, 3))
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def _u32(rows, gen, dev="cuda"):
    """Random (rows, 128) uint32 words."""
    w = torch.randint(-2 ** 31, 2 ** 31, (rows, 128), generator=gen,
                      dtype=torch.int64, device=dev)
    return w.to(torch.int32).view(torch.uint32)


def _word(t):
    return int(t.cpu().tolist()[0])


def phase_kernels():
    from repro_torch.kernels import mpk_guard as mg

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tag = SEED & 0xFFFFFFFF
    err = {}

    # guard_copy + the streaming MAC: rows 0, 1, 7, 63, 64, 65, 256, 65536 and
    # 64 MiB, after a call of many chunks has used the arrival counter; each
    # call twice (the counter is back at 0), the earlier two-pass kernel too
    big = _u32((64 << 20) // 512, gen)
    mg.guard_copy_cuda(big, tag, 0)
    for rows in (0, 1, 7, 63, 64, 65, 256, 65536, (64 << 20) // 512):
        p = big[:rows]
        want = _word(mg.guard_copy_plain(p, tag, 0)[1])
        for guard in (mg.guard_copy_cuda, mg.guard_copy_cuda, mg._guard_copy_two_pass):
            copy, mac, ok = guard(p, tag, want)
            check(_word(mac) == want and _word(ok) == 1,
                  f"{guard.__name__} rows={rows}: mac {_word(mac)} != plain {want}")
            check(torch.equal(copy.view(torch.int32), p.view(torch.int32)),
                  f"{guard.__name__} rows={rows}: copy differs")
        if rows:
            bad = p.clone()
            bad.view(torch.int32)[rows // 2, 77] ^= 1 << (rows % 32)
            check(_word(mg.guard_copy_cuda(bad, tag, want)[2]) == 0,
                  f"guard_copy rows={rows}: tampered payload accepted")
        check(_word(mg.guard_copy_cuda(p, tag ^ 1, want)[2]) == 0,
              f"guard_copy rows={rows}: wrong tag accepted")
        h = mg.mac_init_state_cuda(tag, "cuda")
        check(torch.equal(h.view(torch.int32),
                          mg.mac_init_state_plain(tag, "cuda").view(torch.int32)),
              "mac_init_state differs from plain")
        for a, b in ((0, rows // 3), (rows // 3, rows // 3), (rows // 3, rows)):
            h2 = mg.mac_update_cuda(h, p[a:b])
            check(torch.equal(h2.view(torch.int32),
                              mg.mac_update_plain(h, p[a:b]).view(torch.int32)),
                  f"mac_update rows {a}:{b} differs from plain")
            h = h2
        fin = mg.mac_finalize_cuda(h)
        check(_word(fin) == _word(mg.mac_finalize_plain(h)) == want,
              f"split mac_update rows={rows} != one-shot MAC")
    refuses(lambda: mg.guard_copy_cuda(big.view(torch.int32).view(-1)[1:129]
                                       .view(torch.uint32).view(1, 128), tag, 0),
            "guard_copy")
    del big
    err.update(guard_copy=0, mac_init_state=0, mac_update=0, mac_finalize=0)

    # mac_batch: N = 16 frames with rows 1..64 (and 0)
    for rows in (0, 1, 2, 7, 33, 64):
        st = torch.stack([_u32(rows, gen).view(torch.int32) for _ in range(16)]
                         ).view(torch.uint32)
        got = mg.mac_batch_cuda(st, tag).cpu().tolist()
        check(got == mg.mac_batch_plain(st, tag).cpu().tolist(),
              f"mac_batch rows={rows} differs from plain")
    err["mac_batch"] = 0

    err["decode_attention"] = check_decode(gen)
    err["flash_attention"] = check_flash(gen)
    err["ssd_scan"] = check_ssd(gen)
    frames_on_card_match_cpu()
    torch.cuda.synchronize()
    emit(phase="kernels", ok=True, max_abs_err=err)
    return err

def decode_inputs(gen, B, S, H, Hkv, Dh, dtype, layout="lens", lens=None):
    """Random q/k/v and positions: "lens" fills the first lens[b] slots of
    row b (slot = position, the rest -1), "ring" holds absolute positions
    from 5000 rotated through the slots, as a ring cache does."""
    q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda").to(dtype)
    ar = torch.arange(S, device="cuda")
    if layout == "ring":
        kp = ((ar + 7 * S // 10) % S + 5000)[None].expand(B, S)
        qp = torch.full((B, 1), 5000 + S - 1, device="cuda")
    else:
        lens = torch.tensor(lens if lens is not None else
                            [max(1, S - 37 * b) for b in range(B)], device="cuda")
        kp = torch.where(ar[None] < lens[:, None], ar[None], -1)
        qp = (lens - 1).clamp(min=0)[:, None]
    return q, k, v, qp.to(torch.int32), kp.to(torch.int32).contiguous()


def check_decode(gen):
    """The one-launch decode kernel against its plain version in f32 (2e-5)
    and bf16 (2e-2): the serving shapes, a window, ring positions, S off the
    64-row tile, Dh 128 with one kv head; several splits with the later ones
    fully masked; B·Hkv large enough for one split; the (8, 16384) long
    cache. Each call twice on the same inputs (identical: the arrival
    counters are back at 0), and the earlier two-launch design checked too.
    → the worst bf16 error."""
    from repro_torch.kernels import decode_attention as da
    cases = [  # B, S, H, Hkv, Dh, window, layout, lens, n_split (None: any)
        (8, 1024, 32, 8, 64, None, "lens", None, None),
        (8, 1024, 32, 8, 64, 256, "lens", None, None),
        (4, 1000, 32, 8, 64, 128, "ring", None, None),
        (2, 77, 16, 2, 128, None, "lens", None, None),
        (3, 300, 8, 1, 128, 32, "lens", None, None),
        (2, 4096, 8, 2, 64, None, "lens", [1000, 3], ">1"),
        (3, 700, 12, 4, 64, None, "lens", [0, 1, 700], None),
        (64, 1024, 32, 8, 64, None, "lens", None, "1"),
        (8, 16384, 32, 8, 64, None, "lens", [16384] * 8, ">1"),
    ]
    worst = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for B, S, H, Hkv, Dh, win, layout, lens, splits in cases:
            case = (B, S, H, Hkv, Dh, win, layout, str(dtype))
            q, k, v, qp, kp = decode_inputs(gen, B, S, H, Hkv, Dh, dtype, layout, lens)
            n_split = da.split_plan(B, S, Hkv, da._slots(0, dtype, Dh, H // Hkv))[1]
            check(splits is None or (n_split > 1 if splits == ">1" else n_split == 1),
                  f"decode_attention {case}: the plan has {n_split} splits")
            want = da.decode_attention_plain(q, k, v, qp, kp, window=win)
            got = da.decode_attention_cuda(q, k, v, qp, kp, window=win)
            again = da.decode_attention_cuda(q, k, v, qp, kp, window=win)
            earlier = da._decode_attention_split_merge(q, k, v, qp, kp, window=win)
            e = (got.float() - want.float()).abs().max().item()
            check(e <= tol, f"decode_attention {case}: max err {e} > {tol}")
            check(torch.equal(got, again), f"decode_attention {case}: a second call differs")
            check((earlier.float() - want.float()).abs().max().item() <= tol,
                  f"the earlier decode design {case}: over tolerance")
            if lens is not None and 0 in lens:
                check(got[lens.index(0)].abs().max().item() == 0.0,
                      f"decode_attention {case}: a row with no valid slot is not 0")
            if dtype == torch.bfloat16:
                worst = max(worst, e)
            del q, k, v, want, got, again, earlier
    q, k, v, qp, kp = decode_inputs(gen, 2, 128, 8, 2, 64, torch.bfloat16)
    for i in range(3):
        args = [q, k, v]
        args[i] = misaligned(args[i])
        refuses(lambda: da.decode_attention_cuda(*args, qp, kp), "decode_attention")
    return worst


def flash_inputs(gen, B, Sq, Skv, H, Hkv, Dh, dtype, tail=3, layout="ordered"):
    """Random q/k/v; queries at the last Sq positions of Skv; the last
    ``tail`` kv slots unfilled (kv_pos -1). ``layout`` orders the kv
    positions: "ordered" (slot = position), "ring" (a rotated ring of
    positions from 5000, as a ring cache holds them) or "perm" (a random
    permutation per batch row)."""
    q = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, Hkv, Dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, Hkv, Dh), generator=gen, device="cuda").to(dtype)
    qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32, device="cuda")[None] \
        .expand(B, Sq).contiguous()
    ar = torch.arange(Skv, device="cuda")
    if layout == "ring":
        kp = ((ar + 7 * Skv // 10) % Skv + 5000)[None].repeat(B, 1)
        qp = qp + 5000
    elif layout == "perm":
        kp = torch.stack([torch.randperm(Skv, generator=gen, device="cuda")
                          for _ in range(B)])
    else:
        kp = ar[None].repeat(B, 1)
    kp = kp.to(torch.int32)
    if tail:
        kp[:, -tail:] = -1
    return q, k, v, qp, kp


def misaligned(t):
    """A contiguous copy of ``t`` whose start is 2 bytes off 16-byte
    alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def refuses(fn, what):
    """Fail unless ``fn()`` raises ValueError."""
    try:
        fn()
    except ValueError:
        return
    check(False, f"{what}: accepted a misaligned input")


def check_flash(gen):
    """The flash kernel against its plain version: the prefill shape
    (4, 2048, 32, 8, 64) causal in bf16 and f32, a window, non-causal with
    Skv != Sq, padded query rows (exactly 0), kv_pos -1 tails, Dh 128 with
    one kv head, ragged lengths; kv positions out of order (a rotated ring
    and random permutations, the tile skip must stay conservative), Sq and
    Skv off the 64- and 128-row tiles at Dh 128, and windows whose edges
    fall inside tiles. → the worst bf16 error."""
    from repro_torch.kernels import flash_attention as fa
    cases = [  # B, Sq, Skv, H, Hkv, Dh, causal, window, tail, padded q rows, layout
        (4, 2048, 2048, 32, 8, 64, True, None, 0, 0, "ordered"),
        (2, 700, 700, 16, 4, 64, True, 128, 3, 0, "ordered"),
        (2, 300, 1000, 8, 8, 64, False, None, 37, 5, "ordered"),
        (2, 257, 257, 8, 1, 128, True, None, 3, 2, "ordered"),
        (3, 1, 333, 4, 2, 128, True, 64, 3, 0, "ordered"),
        (2, 300, 1000, 16, 4, 64, True, 256, 0, 0, "ring"),
        (2, 200, 777, 8, 2, 128, True, None, 5, 0, "perm"),
        (2, 190, 600, 8, 4, 128, False, 70, 0, 3, "perm"),
        (2, 333, 459, 16, 8, 128, True, None, 5, 3, "ordered"),
        (1, 517, 517, 8, 2, 64, True, 100, 0, 0, "ordered"),
    ]
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for B, Sq, Skv, H, Hkv, Dh, causal, win, tail, pad, layout in cases:
            q, k, v, qp, kp = flash_inputs(gen, B, Sq, Skv, H, Hkv, Dh, dtype, tail,
                                           layout)
            if pad:
                qp[:, -pad:] = -2
            got = fa.flash_attention_cuda(q, k, v, qp, kp, causal=causal, window=win)
            want = fa.flash_attention_plain(q, k, v, qp, kp, causal=causal,
                                            window=win)
            e = (got.float() - want.float()).abs().max().item()
            case = (B, Sq, Skv, H, Hkv, Dh, causal, win, tail, pad, layout, str(dtype))
            check(e <= tol, f"flash_attention {case}: max err {e} > {tol}")
            check(not pad or got[:, -pad:].abs().max().item() == 0.0,
                  f"flash_attention {case}: a padded query row is not 0")
            if dtype == torch.bfloat16:
                worst = max(worst, e)
            del q, k, v, got, want
    q, k, v, qp, kp = flash_inputs(gen, 1, 64, 64, 4, 2, 64, torch.bfloat16, 0,
                                   "ordered")
    refuses(lambda: fa.flash_attention_cuda(q, misaligned(k), v, qp, kp),
            "flash_attention")
    return worst


def ssd_inputs(gen, B, S, H, P, G, N, dtype):
    """x, B, C ~ N(0, 1); A_log = log(1..H) and dt = softplus(N(0, 1) +
    dt_bias) with dt_bias drawn as mamba2's init draws it (dt in [1e-3,
    1e-1] before the input term), D = 1."""
    import math
    import torch.nn.functional as F
    x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
    u = torch.rand((H,), generator=gen, device="cuda")
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device="cuda") + dt_bias)
    A_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32, device="cuda"))
    Bm = torch.randn((B, S, G, N), generator=gen, device="cuda").to(dtype)
    Cm = torch.randn((B, S, G, N), generator=gen, device="cuda").to(dtype)
    return x, dt, A_log, Bm, Cm, torch.ones(H, device="cuda")


def check_ssd(gen):
    """The SSD kernel against its plain version (both finite) at mamba2's
    prefill shape (4, 2048, 64, 64, G=1, N=128, Q=128), a length that is not
    a chunk multiple, an init_state, G > 1, one step, a sequence shorter
    than one chunk, and mamba2's shape run as two calls (the first call's
    final state the second's init_state) against one plain call over the
    whole sequence; and shapes whose bf16 y tile (Q x P) is larger than
    their f32 S_in (P x N); |got - want| <= tol·(1 + |want|) with tol 1e-4 in f32
    and 2e-2 in bf16. → the worst bf16 absolute error."""
    from repro_torch.kernels import ssd_scan as ss
    cases = [  # B, S, H, P, G, N, Q, init
        (4, 2048, 64, 64, 1, 128, 128, False),
        (2, 1000, 16, 64, 4, 128, 128, True),
        (1, 77, 8, 32, 2, 64, 64, False),
        (2, 1, 16, 64, 2, 128, 128, True),
        (2, 77, 16, 64, 1, 128, 128, True),
        (2, 300, 16, 64, 2, 64, 128, True),
        (2, 300, 8, 32, 1, 32, 128, False),
        (1, 200, 16, 64, 4, 32, 64, True),
    ]
    worst = 0.0

    def compare(case, pairs, tol):
        check(all(bool(torch.isfinite(t).all()) for pair in pairs for t in pair),
              f"ssd_scan {case}: a non-finite output")
        for got, want in pairs:
            excess = ((got - want).abs() - tol * (1 + want.abs())).max().item()
            check(excess <= 0, f"ssd_scan {case}: error over tolerance by {excess}")
        return (pairs[0][0] - pairs[0][1]).abs().max().item()

    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for B, S, H, P, G, N, Q, init in cases:
            x, dt, A_log, Bm, Cm, D = ssd_inputs(gen, B, S, H, P, G, N, dtype)
            s0 = (torch.randn((B, H, P, N), generator=gen, device="cuda")
                  if init else None)
            y, st = ss.ssd_scan_cuda(x, dt, A_log, Bm, Cm, D, s0, chunk=Q)
            yw, sw = ss.ssd_scan_plain(x, dt, A_log, Bm, Cm, D, s0, chunk=Q)
            e = compare((B, S, H, P, G, N, Q, init, str(dtype)),
                        [(y.float(), yw.float()), (st, sw)], tol)
            worst = max(worst, e) if dtype == torch.bfloat16 else worst
            del x, y, yw

        # continuation: two calls split at step 1000 (inside a chunk)
        x, dt, A_log, Bm, Cm, D = ssd_inputs(gen, 4, 2048, 64, 64, 1, 128, dtype)
        cut = 1000
        part = [t[:, :cut].contiguous() for t in (x, dt, Bm, Cm)]
        rest = [t[:, cut:].contiguous() for t in (x, dt, Bm, Cm)]
        y1, s1 = ss.ssd_scan_cuda(part[0], part[1], A_log, part[2], part[3], D)
        y2, s2 = ss.ssd_scan_cuda(rest[0], rest[1], A_log, rest[2], rest[3], D, s1)
        yw, sw = ss.ssd_scan_plain(x, dt, A_log, Bm, Cm, D)
        e = compare(("continuation at", cut, str(dtype)),
                    [(torch.cat([y1, y2], 1).float(), yw.float()), (s2, sw)], tol)
        worst = max(worst, e) if dtype == torch.bfloat16 else worst
        del x, y1, y2, yw
    x, dt, A_log, Bm, Cm, D = ssd_inputs(gen, 1, 64, 8, 64, 1, 128, torch.bfloat16)
    refuses(lambda: ss.ssd_scan_cuda(x, dt, A_log, Bm, misaligned(Cm), D, chunk=64),
            "ssd_scan")
    return worst


def frames_on_card_match_cpu():
    """A frame sealed by the kernels equals the one the plain versions seal
    on the CPU, verifies on the card, and is refused once tampered. A CPU
    call adds nothing to the launch counts."""
    import numpy as np
    from repro_torch.core import framing
    from repro_torch.kernels import ops

    arr = np.arange(300, dtype=np.int32)
    ops.LAUNCHES.reset()
    on_cpu = framing.build_frame(arr, seed=7, seq=3, priority=1, device="cpu")
    check(sum(ops.LAUNCHES.snapshot().values()) == 0,
          "a CPU seal counted a kernel launch")
    on_card = framing.build_frame(arr, seed=7, seq=3, priority=1, device="cuda")
    check(torch.equal(on_card.view(torch.int32).cpu(), on_cpu.view(torch.int32)),
          "a frame sealed on the card differs from the CPU's")
    got = framing.verify_view(on_card, seed=7, expect_seq=3)
    check(got.device.type == "cuda" and got.cpu().tolist() == arr.tolist(),
          "a frame sealed on the card does not verify there")
    on_card.view(torch.int32)[2, 9] ^= 1
    try:
        framing.verify_view(on_card, seed=7, expect_seq=3)
        check(False, "a tampered frame verified on the card")
    except framing.FrameError:
        pass


# ---------------------------------------------------------------------------
# 3. serve at full width
# ---------------------------------------------------------------------------

def _engine(cfg, dtype, seed, max_batch, max_seq, impl=None):
    from repro_torch.models import Impl, init_params
    from repro_torch.runtime import ServingEngine
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed),
                         dtype=dtype)
    return ServingEngine(cfg, params, max_batch=max_batch, max_seq=max_seq,
                         impl=impl or Impl(), dtype=dtype, device="cuda")


GUARD_KERNELS = ("guard_copy", "mac_batch", "mac_init_state", "mac_update",
                 "mac_finalize")


def phase_prefill(cfg, kernel, per_call, n_calls=3, B=4, S=2048):
    """``make_prefill_step`` at full width and depth in bf16 over B prompts
    of S tokens; ``kernel`` must launch ``per_call`` times per call."""
    from repro_torch.kernels import ops
    from repro_torch.models import Impl, init_params
    from repro_torch.models.layers import padded_vocab
    from repro_torch.runtime.steps import make_prefill_step

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                         dtype=torch.bfloat16)
    step = make_prefill_step(cfg, Impl(), dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda")}
    step(params, batch)                      # warm-up (library loads), not measured
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        logits = step(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES.snapshot()
    check(launches[kernel] == per_call * n_calls,
          f"{cfg.name} prefill: {launches[kernel]} {kernel} launches in "
          f"{n_calls} calls, want {per_call} per call")
    check(logits.shape == (B, 1, padded_vocab(cfg.vocab_size))
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          f"{cfg.name} prefill: logits {tuple(logits.shape)} not finite")
    ms = wall / n_calls * 1e3
    emit(phase="prefill", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype="bfloat16", batch=B, prompt_len=S,
         calls=n_calls, ms_per_prefill=ms, prompt_tokens_per_s=B * S / ms * 1e3,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, logits_finite=True)
    del params, batch, logits
    torch.cuda.empty_cache()
    return launches


def phase_serve(cfg, n_clients=12):
    """The engine behind the service step at full width and depth (bf16):
    lockstep clients, one batch envelope of 8, a tampered frame. → (the
    launch counts of that run, the layer-0 KV cache and positions of a
    dense model or None)."""
    from repro_torch.core import framing, transports
    from repro_torch.kernels import ops
    from repro_torch.runtime import EngineService, encode_prompt

    max_new = 32
    path = GUARD_KERNELS + (("decode_attention",) if cfg.family == "dense" else ())
    eng = _engine(cfg, torch.bfloat16, 0, 8, 1024)
    svc = EngineService(eng, timeout=600).start()
    rng = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(0, cfg.vocab_size, (8 + (40 * i) // 11,),
                             generator=rng).tolist() for i in range(n_clients)]
    results, errors = {}, []

    def client(i):          # one lockstep exchange: seal, serve, verify
        try:
            frame = framing.build_frame(encode_prompt(prompts[i], max_new),
                                        seed=SEED, seq=i, device="cuda")
            resp = transports.serve_frame(frame, svc.handler, seed=SEED, seq=i)
            results[i] = framing.verify_view(resp, seed=SEED,
                                             expect_seq=i).cpu().tolist()
        except BaseException as e:
            errors.append(repr(e))

    try:
        # warm-up exchange (library loads, first-call costs), not measured
        warm = framing.build_frame(encode_prompt(prompts[0], 2), seed=SEED,
                                   seq=999, device="cuda")
        transports.serve_frame(warm, svc.handler, seed=SEED, seq=999)
        torch.cuda.synchronize()
        ops.LAUNCHES.reset()
        ticks0, t0 = eng.ticks, time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), "a lockstep client did not finish")
        torch.cuda.synchronize()
        lock_s, lock_ticks = time.perf_counter() - t0, eng.ticks - ticks0
        check(not errors, f"lockstep clients failed: {errors}")

        # one batch envelope of 8 through handler_batch
        reqs = [encode_prompt(p, max_new) for p in prompts[:8]]
        seqs = list(range(100, 108))
        env = torch.cat(framing.seal_batch(reqs, seed=SEED, seqs=seqs,
                                           device="cuda"))
        ticks1, t1 = eng.ticks, time.perf_counter()
        out = transports.serve_batch(env, svc.handler_batch, seed=SEED, seqs=seqs)
        check(all(isinstance(o, torch.Tensor) for o in out),
              f"batch envelope items failed: {out}")
        batch = [r.cpu().tolist() for r in framing.verify_batch(out, seed=SEED,
                                                                 seqs=seqs)]
        torch.cuda.synchronize()
        batch_s, batch_ticks = time.perf_counter() - t1, eng.ticks - ticks1

        # a frame with one flipped bit is refused by the guard
        bad = framing.build_frame(encode_prompt(prompts[0], 4), seed=SEED,
                                  seq=200, device="cuda")
        bad.view(torch.int32)[1, 3] ^= 1 << 9
        try:
            transports.serve_frame(bad, svc.handler, seed=SEED, seq=200)
            refused = False
        except framing.FrameError:
            refused = True
        torch.cuda.synchronize()
        launches = ops.LAUNCHES.snapshot()
    finally:
        svc.close()

    check(refused, "a tampered frame was served")
    toks = [results.get(i) for i in range(n_clients)] + batch
    check(all(t is not None and len(t) == max_new and
              all(0 <= x < cfg.vocab_size for x in t) for t in toks),
          "a response is missing, short or out of the vocabulary")
    check(all(launches[n] > 0 for n in path),
          f"a kernel of the serving path never launched: {launches}")
    same = sum(results[i] == batch[i] for i in range(8))
    lock_tokens = n_clients * max_new
    emit(phase="serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         dtype="bfloat16", max_batch=8, max_seq=1024, lockstep_requests=n_clients,
         prompt_tokens=[len(p) for p in prompts], max_new=max_new,
         lockstep_s=lock_s, lockstep_ticks=lock_ticks,
         lockstep_tokens_per_s=lock_tokens / lock_s,
         ms_per_tick=lock_s / lock_ticks * 1e3,
         batch_requests=8, batch_s=batch_s, batch_ticks=batch_ticks,
         batch_tokens_per_s=8 * max_new / batch_s,
         batch_ms_per_tick=batch_s / batch_ticks * 1e3,
         batch_matches_lockstep=same, tampered_frame_refused=refused,
         launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    attn_inputs = None
    if cfg.family == "dense":
        caches = eng.state["caches"]
        attn_inputs = (caches["k"][0].clone(), caches["v"][0].clone(),
                       eng.state["pos"].clamp(max=eng.max_seq - 1).clone())
    del eng, svc
    torch.cuda.empty_cache()
    return launches, attn_inputs


# ---------------------------------------------------------------------------
# 4. parity at full width in f32
# ---------------------------------------------------------------------------

def phase_parity(cfg):
    from repro_torch.models import Impl
    from repro_torch.runtime import Request

    prompts = [[11, 22, 33, 44, 55, 66, 77, 88], [5, 4, 3, 2, 1, 0, 9]]
    toks = {}
    for impl in ("kernel", "plain"):
        eng = _engine(cfg, torch.float32, 1, 2, 64, Impl(decode_attention=impl))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=16))
        toks[impl] = {r.rid: r.generated for r in eng.run_until_drained()}
        del eng
        torch.cuda.empty_cache()
    check(toks["kernel"] == toks["plain"],
          f"kernel and plain decode attention disagree: {toks}")
    check(all(len(t) == 16 for t in toks["kernel"].values()), "short output")

    # the reduced model: the whole engine on the card against it on the CPU
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params
    from repro_torch.runtime import ServingEngine
    small = get_reduced(cfg.name)
    params = init_params(small, torch.Generator().manual_seed(0))
    outs = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(small, _to(params, device), max_batch=2, max_seq=32,
                            impl=Impl(), dtype=torch.float32, device=device)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=[3 + i, 1, 4], max_new=6))
        outs[device] = {r.rid: r.generated for r in eng.run_until_drained()}
    check(outs["cuda"] == outs["cpu"],
          f"the reduced engine on the card and on the CPU disagree: {outs}")
    emit(phase="parity", dtype="float32", requests=len(prompts), new_tokens=16,
         identical=True, reduced_card_equals_cpu=True)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def phase_prefill_parity(cfg, B=2, S=160, S_dec=16):
    """In f32 at full width: the forward with the kernels against the
    forward with the plain versions (the same argmax wherever the top two
    logits are more than 100x the difference apart; near ties are counted),
    and the last prefill logits against decode_step token by token."""
    from repro_torch.models import (Impl, decode_step, forward,
                                    init_decode_state, init_params)
    from repro_torch.runtime.steps import make_prefill_step

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                         dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    V = cfg.vocab_size
    lk, _ = forward(cfg, params, {"tokens": toks}, impl=Impl(), dtype=torch.float32)
    lp, _ = forward(cfg, params, {"tokens": toks}, dtype=torch.float32,
                    impl=Impl(attention="plain", decode_attention="plain",
                              ssd="plain"))
    lk, lp = lk[..., :V], lp[..., :V]
    kern_err = (lk - lp).abs().max().item()
    top2 = lp.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 100 * kern_err
    same = lk.argmax(-1) == lp.argmax(-1)
    check(bool(torch.isfinite(lk).all()) and bool(same[decided].all()),
          f"{cfg.name}: kernel and plain forwards disagree (max err {kern_err})")
    del lk, lp

    short = toks[:, :S_dec]
    pre = make_prefill_step(cfg, Impl(), dtype=torch.float32)(
        params, {"tokens": short})[:, 0, :V]
    st = init_decode_state(cfg, B, S_dec, dtype=torch.float32, device="cuda")
    for t in range(S_dec):
        lg, st = decode_step(cfg, params, st, short[:, t:t + 1], impl=Impl(),
                             dtype=torch.float32)
    dec = lg[:, 0, :V]
    dec_err = (pre - dec).abs().max().item()
    check(torch.equal(pre.argmax(-1), dec.argmax(-1)) and dec_err <= 1e-3,
          f"{cfg.name}: prefill and decode disagree (max err {dec_err})")
    emit(phase="parity_prefill", arch=cfg.name, dtype="float32", batch=B,
         prompt_len=S, kernel_vs_plain_max_abs=kern_err,
         argmax_identical=bool(same.all()), near_ties=int((~decided).sum()),
         decode_prompt_len=S_dec, prefill_vs_decode_max_abs=dec_err,
         prefill_decode_argmax_identical=True)
    del params, st
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the kernels line
# ---------------------------------------------------------------------------

def kernels_line(cfg, launches, err, attn_inputs):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mpk_guard as mg
    from repro_torch.models import kvcache

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tag = SEED & 0xFFFFFFFF
    rows = []

    def row(name, source, replaces, *args, **extra):
        rows.append(_row(name, source, replaces, launches, err, *args, **extra))

    def guard_times(n, calls):
        """guard_copy on n rows: eager, plain, copy_, the earlier two-pass
        kernel, graph replay of ``calls`` calls, kernels per call."""
        p = _u32(n, gen)
        want = _word(mg.guard_copy_plain(p, tag, 0)[1])
        dst = torch.empty_like(p)
        it = 200 if n < 4096 else 50
        kpc = kernels_per_call(lambda: mg.guard_copy_cuda(p, tag, want))
        check(kpc == 1, f"guard_copy on {n} rows: {kpc} kernels per call")
        return dict(ms=cuda_ms(lambda: mg.guard_copy_cuda(p, tag, want), it),
                    plain_ms=cuda_ms(lambda: mg.guard_copy_plain(p, tag, want),
                                     max(5, it // 10)),
                    library_ms=cuda_ms(lambda: dst.copy_(p), it),
                    earlier_ms=cuda_ms(lambda: mg._guard_copy_two_pass(p, tag, want), it),
                    graph_ms=graph_ms([lambda: mg.guard_copy_cuda(p, tag, want)] * calls),
                    earlier_graph_ms=graph_ms(
                        [lambda: mg._guard_copy_two_pass(p, tag, want)] * calls),
                    kernels_per_call=kpc,
                    earlier_kernels_per_call=kernels_per_call(
                        lambda: mg._guard_copy_two_pass(p, tag, want)),
                    nbytes=2 * n * 512 + 12, ops=2 * n * 128)

    # guard_copy: a request / response payload is one 512-byte row
    one = guard_times(1, 20)
    big = guard_times((64 << 20) // 512, 4)
    bb, bby = bound(big.pop("nbytes"), big.pop("ops"), "fp32")
    row("guard_copy", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:93",
        "(1, 128) uint32", one["ms"], one["plain_ms"], one["nbytes"], one["ops"],
        "fp32", one["library_ms"], earlier_ms=one["earlier_ms"], graph_ms=one["graph_ms"],
        earlier_graph_ms=one["earlier_graph_ms"], kernels_per_call=one["kernels_per_call"],
        earlier_kernels_per_call=one["earlier_kernels_per_call"],
        at_64MiB=dict(big, bound_ms=bb, bound_by=bby))

    # mac_batch: the batch envelope's 8 one-row frames
    st = torch.stack([_u32(1, gen).view(torch.int32) for _ in range(8)]
                     ).view(torch.uint32)
    check(torch.equal(mg.mac_batch_cuda(st, tag).view(torch.int32).cpu(),
                      mg.mac_batch_plain(st, tag).view(torch.int32).cpu()),
          "mac_batch at the envelope's shape differs from plain")
    row("mac_batch", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:153",
        "(8, 1, 128) uint32", cuda_ms(lambda: mg.mac_batch_cuda(st, tag), 200),
        cuda_ms(lambda: mg.mac_batch_plain(st, tag), 20), 8 * 512 + 32,
        2 * 8 * 128, "fp32", None)

    # the streaming seal of a one-row frame: init, update, finalize
    h = mg.mac_init_state_cuda(tag, "cuda")
    blk = _u32(1, gen)
    row("mac_init_state", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:203",
        "(128,) uint32", cuda_ms(lambda: mg.mac_init_state_cuda(tag, "cuda"), 200),
        cuda_ms(lambda: mg.mac_init_state_plain(tag, "cuda"), 50), 512, 128,
        "fp32", cuda_ms(lambda: torch.full((128,), 7, dtype=torch.int32,
                                           device="cuda"), 200))
    big_blk = _u32(65536, gen)
    row("mac_update", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:241",
        "(1, 128) uint32 block", cuda_ms(lambda: mg.mac_update_cuda(h, blk), 200),
        cuda_ms(lambda: mg.mac_update_plain(h, blk), 50), 3 * 512, 2 * 128,
        "fp32", None,
        at_65536_rows=dict(
            ms=cuda_ms(lambda: mg.mac_update_cuda(h, big_blk), 50),
            plain_ms=cuda_ms(lambda: mg.mac_update_plain(h, big_blk), 5),
            bound_ms=bound(65536 * 512, 2 * 65536 * 128, "fp32")[0]))
    row("mac_finalize", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:271",
        "(128,) uint32", cuda_ms(lambda: mg.mac_finalize_cuda(h), 200),
        cuda_ms(lambda: mg.mac_finalize_plain(h), 50), 516, 2 * 128, "fp32", None)

    # decode attention on the serving run's layer-0 cache and positions
    k, v, pos = attn_inputs
    B, S, Hkv, Dh = k.shape
    H = cfg.num_heads
    q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(k.dtype)
    qp = pos.to(torch.int32)[:, None]
    kp = kvcache.dense_cache_positions_rows({"k": k}, pos + 1)
    valid = int((kp >= 0).sum())
    nbytes = 2 * valid * Hkv * Dh * k.element_size() + 2 * q.numel() * 2 \
        + kp.numel() * 4 + B * 4
    serve_err = (da.decode_attention_cuda(q, k, v, qp, kp).float()
                 - da.decode_attention_plain(q, k, v, qp, kp).float()).abs().max().item()
    check(serve_err <= 2e-2, f"decode_attention on the serving cache: {serve_err}")
    err = dict(err, decode_attention=max(err["decode_attention"], serve_err))
    kpc = kernels_per_call(lambda: da.decode_attention_cuda(q, k, v, qp, kp))
    check(kpc == 1, f"decode_attention: {kpc} kernels per call")
    row("decode_attention", "decode_attention.cu",
        "src/repro/kernels/decode_attention.py:71",
        f"q ({B}, 1, {H}, {Dh}) bf16, cache ({B}, {S}, {Hkv}, {Dh}), "
        f"{valid} valid rows", cuda_ms(lambda: da.decode_attention_cuda(
            q, k, v, qp, kp), 200),
        cuda_ms(lambda: da.decode_attention_plain(q, k, v, qp, kp), 50),
        nbytes, 4 * H * Dh * valid, "bf16", sdpa_ms([(q, k, v, kp)], 200),
        valid_rows=valid,
        earlier_ms=cuda_ms(lambda: da._decode_attention_split_merge(q, k, v, qp, kp), 200),
        graph_ms=graph_ms([lambda: da.decode_attention_cuda(q, k, v, qp, kp)] * 16),
        earlier_graph_ms=graph_ms(
            [lambda: da._decode_attention_split_merge(q, k, v, qp, kp)] * 16),
        kernels_per_call=kpc,
        earlier_kernels_per_call=kernels_per_call(
            lambda: da._decode_attention_split_merge(q, k, v, qp, kp)),
        split_plan=da.split_plan(B, S, Hkv, da._slots(0, q.dtype, Dh, H // Hkv)),
        at_full_cache=decode_at(gen, B, 1024, H, Hkv, Dh, layers=cfg.num_layers),
        at_long_cache=decode_at(gen, B, 16384, H, Hkv, Dh, layers=1))
    del q, k, v, attn_inputs
    torch.cuda.empty_cache()
    rows.append(flash_row(gen, launches, err))
    rows.append(ssd_row(gen, launches, err))
    return rows


def sdpa_ms(caches, iters):
    """ms per call of PyTorch's scaled_dot_product_attention (bool mask from
    kv_pos >= 0, enable_gqa) over ``caches`` [(q, k, v, kv_pos)] in turn."""
    import torch.nn.functional as F
    args = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             (kp >= 0)[:, None, None, :]) for q, k, v, kp in caches]

    def run():
        for qs, ks, vs, mask in args:
            F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    return cuda_ms(run, iters) / len(caches)


def decode_at(gen, B, S, H, Hkv, Dh, layers):
    """Decode attention over ``layers`` distinct (B, S, Hkv, Dh) bf16 caches
    with every row valid, called in turn as a decode tick calls its layers:
    with 16 layers of (8, 1024, 8, 64) (268 MB) or one (8, 16384, 8, 64)
    cache (268 MB) each call finds its cache cold in L2. Eager, graph replay
    (one capture of a pass over the layers), the earlier design, SDPA, the
    byte bound; the first layer against the plain version (2e-2)."""
    from repro_torch.kernels import decode_attention as da
    q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    caches = [tuple(torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda")
                    .to(torch.bfloat16) for _ in range(2)) for _ in range(layers)]
    kp = torch.arange(S, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    qp = torch.full((B, 1), S - 1, dtype=torch.int32, device="cuda")
    k0, v0 = caches[0]
    e = (da.decode_attention_cuda(q, k0, v0, qp, kp).float()
         - da.decode_attention_plain(q, k0, v0, qp, kp).float()).abs().max().item()
    check(e <= 2e-2, f"decode_attention at ({B}, {S}): max err {e}")
    calls = [lambda k=k, v=v: da.decode_attention_cuda(q, k, v, qp, kp) for k, v in caches]
    earlier = [lambda k=k, v=v: da._decode_attention_split_merge(q, k, v, qp, kp)
               for k, v in caches]
    per_pass = 32 // layers              # 32 calls: 2 passes over 16 layers, or 32 calls
    calls, earlier = calls * per_pass, earlier * per_pass
    b_ms, by = bound(2 * B * S * Hkv * Dh * 2 + 2 * q.numel() * 2 + kp.numel() * 4 + B * 4,
                     4 * H * Dh * B * S, "bf16")
    out = dict(shape=f"q ({B}, 1, {H}, {Dh}) bf16 over {layers} x ({B}, {S}, {Hkv}, {Dh})"
                     f" bf16 caches, every row valid, in turn",
               ms=cuda_ms(lambda: [c() for c in calls], 10) / len(calls),
               graph_ms=graph_ms(calls),
               earlier_ms=cuda_ms(lambda: [c() for c in earlier], 3) / len(earlier),
               bound_ms=b_ms, bound_by=by, max_abs_err=e,
               split_plan=da.split_plan(B, S, Hkv, da._slots(0, torch.bfloat16, Dh, H // Hkv)),
               library_ms=sdpa_ms([(q, k, v, kp) for k, v in caches], 5))
    del caches
    torch.cuda.empty_cache()
    return out


def _row(name, source, replaces, launches, err, shape, ms, plain_ms, nbytes,
         ops, kind, library_ms, **extra):
    """One entry of the kernels line; the bound from ``nbytes`` and ``ops``."""
    b, by = bound(nbytes, ops, kind)
    return dict(name=name, route="cuda", source=f"{SRC}/{source}",
                replaces=replaces, launches=launches[name], max_abs_err=err[name],
                ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=library_ms, shape=shape, **extra)


def tensor_core_instr(source, kernels):
    """The tensor-core instructions (HGMMA, HMMA) in the SASS of the
    functions of the built ``source`` library whose names contain one of
    ``kernels``, counted from ``cuobjdump -sass``."""
    import re
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = any(k in line for k in kernels)
        elif inside and re.search(r"\bH(G)?MMA\.", line):
            count += 1
    return count


def flash_row(gen, launches, err):
    """Flash attention at the llama3.2-1b prefill's shape: 4 prompts of
    2048 tokens, 32 query heads over 8 kv heads of 64, causal, bf16. The
    operations are 4·Dh·H per valid (q, kv) pair of this run's positions.
    ``earlier_ms`` is the CUDA-core design timed here on the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, S, H, Hkv, Dh = 4, 2048, 32, 8, 64
    q, k, v, qp, kp = flash_inputs(gen, B, S, S, H, Hkv, Dh, torch.bfloat16, tail=0)
    pairs = int(((kp[:, None, :] <= qp[:, :, None]) & (kp[:, None, :] >= 0)).sum())
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + (qp.numel() + kp.numel()) * 4
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), 20)
    return _row("flash_attention", "flash_attention.cu",
                "src/repro/kernels/flash_attention.py:76", launches, err,
                f"q ({B}, {S}, {H}, {Dh}) bf16 over k/v ({B}, {S}, {Hkv}, {Dh}), "
                f"causal", cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, qp, kp),
                                   20),
                cuda_ms(lambda: fa.flash_attention_plain(q, k, v, qp, kp), 2),
                nbytes, 4 * Dh * H * pairs, "bf16", lib, valid_pairs=pairs,
                earlier_ms=cuda_ms(lambda: fa._flash_attention_cuda_cores(
                    q, k, v, qp, kp), 5),
                kernels_per_call=1,
                tensor_core_instr=tensor_core_instr("flash_attention",
                                                    ("flash_fwd_wgmma",)))


def ssd_row(gen, launches, err):
    """The SSD scan at the mamba2-1.3b prefill's shape: 4 prompts of 2048
    tokens, 64 heads of 64, one group of N = 128, chunk 128, bf16. The
    operations are the chunked form's: per chunk and head, C·Bᵀ and att·x
    over the Q(Q+1)/2 causal pairs, the inter term and the state carry.
    A call is three kernels, each also timed alone (``pass_ms``);
    ``earlier_ms`` is the CUDA-core design timed here on the same inputs."""
    from repro_torch.kernels import ssd_scan as ss
    B, S, H, P, G, N, Q = 4, 2048, 64, 64, 1, 128, 128
    x, dt, A_log, Bm, Cm, D = ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16)
    n_chunks = -(-S // Q)
    ops = 2 * B * H * n_chunks * (Q * (Q + 1) // 2 * (N + P) + 2 * Q * N * P)
    nbytes = (2 * x.numel() + Bm.numel() + Cm.numel()) * 2 + dt.numel() * 4 \
        + 2 * H * 4 + B * H * P * N * 4
    _, passes = ss.bf16_launches(x, dt, A_log, Bm, Cm, D, chunk=Q)
    return _row("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:70",
                launches, err,
                f"x ({B}, {S}, {H}, {P}) bf16, B/C ({B}, {S}, {G}, {N}), chunk {Q}",
                cuda_ms(lambda: ss.ssd_scan_cuda(x, dt, A_log, Bm, Cm, D, chunk=Q),
                        20),
                cuda_ms(lambda: ss.ssd_scan_plain(x, dt, A_log, Bm, Cm, D,
                                                  chunk=Q), 2),
                nbytes, ops, "bf16", None,
                earlier_ms=cuda_ms(lambda: ss._ssd_scan_cuda_cores(
                    x, dt, A_log, Bm, Cm, D, chunk=Q), 5),
                kernels_per_call=len(passes),
                pass_ms={name: cuda_ms(run, 20) for name, run in passes},
                tensor_core_instr=tensor_core_instr(
                    "ssd_scan", ("ssd_states_mma", "ssd_output_mma")))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.configs import get_config
    from repro_torch.device import resolve
    resolve("cuda")                          # TF32 off for the f32 phase

    t0 = time.perf_counter()
    smi = phase_card()
    err = phase_kernels()
    llama, mamba = get_config("llama3.2-1b"), get_config("mamba2-1.3b")
    launches = {}                            # summed over the main-path runs

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    add(phase_prefill(llama, "flash_attention", llama.num_layers))
    add(phase_prefill(mamba, "ssd_scan", mamba.num_layers))
    counts, attn_inputs = phase_serve(llama)
    add(counts)
    add(phase_serve(mamba, n_clients=8)[0])
    kernels = kernels_line(llama, launches, err, attn_inputs)
    del attn_inputs
    torch.cuda.empty_cache()
    phase_parity(llama)
    phase_prefill_parity(llama)
    phase_prefill_parity(mamba)
    emit(phase="done", wall_s=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
