#!/usr/bin/env python3
"""The PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. card    — name and power limit (nvidia-smi), and the build of every
             CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per
             source, in parallel).
2. kernels — each kernel against its plain PyTorch version on the card, at
             the serving path's shapes and at edge cases (guard MACs
             bit-exact, decode attention at 2e-5 in f32 and 2e-2 in bf16).
3. serve   — llama3.2-1b at full width and depth (bf16, random weights from
             a seeded generator), max_batch 8, max_seq 1024: 12 concurrent
             lockstep clients and one batch envelope of 8, every request and
             response a sealed frame through the service step; a tampered
             frame must be refused. The kernels' launch counts are zeroed
             just before and read just after; each must be > 0.
4. parity  — the same model in f32: the engine with the decode-attention
             kernel and with its plain version give identical greedy tokens;
             and the reduced model's engine on the card and on the CPU.

Then a ``kernels`` JSON line (times from CUDA events, bounds from this
run's inputs), the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Imports neither JAX nor the ``repro``
package.
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
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mpk_guard as mg

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tag = SEED & 0xFFFFFFFF
    err = {}

    # guard_copy + the streaming MAC: rows 0, 1, 7, 256, 65536 and 64 MiB
    for rows in (0, 1, 7, 256, 65536, (64 << 20) // 512):
        p = _u32(rows, gen)
        want = _word(mg.guard_copy_plain(p, tag, 0)[1])
        copy, mac, ok = mg.guard_copy_cuda(p, tag, want)
        check(_word(mac) == want and _word(ok) == 1,
              f"guard_copy rows={rows}: mac {_word(mac)} != plain {want}")
        check(torch.equal(copy.view(torch.int32), p.view(torch.int32)),
              f"guard_copy rows={rows}: copy differs")
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
    err.update(guard_copy=0, mac_init_state=0, mac_update=0, mac_finalize=0)

    # mac_batch: N = 16 frames with rows 1..64 (and 0)
    for rows in (0, 1, 2, 7, 33, 64):
        st = torch.stack([_u32(rows, gen).view(torch.int32) for _ in range(16)]
                         ).view(torch.uint32)
        got = mg.mac_batch_cuda(st, tag).cpu().tolist()
        check(got == mg.mac_batch_plain(st, tag).cpu().tolist(),
              f"mac_batch rows={rows} differs from plain")
    err["mac_batch"] = 0

    # decode attention at the serving shapes, window and ring positions
    worst = 0.0
    cases = [(8, 1024, 32, 8, 64, None, False), (8, 1024, 32, 8, 64, 256, False),
             (4, 1000, 32, 8, 64, 128, True), (2, 77, 16, 2, 128, None, False),
             (3, 300, 8, 1, 128, 32, False)]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for B, S, H, Hkv, Dh, win, ring in cases:
            q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda").to(dtype)
            ar = torch.arange(S, device="cuda")
            if ring:      # slots hold absolute positions out of order
                kp = ((ar + 7 * S // 10) % S + 5000)[None].expand(B, S)
                qp = torch.full((B, 1), 5000 + S - 1, device="cuda")
            else:
                lens = torch.tensor([S - 37 * b for b in range(B)], device="cuda")
                kp = torch.where(ar[None] < lens[:, None], ar[None], -1)
                qp = (lens - 1)[:, None]
            kp = kp.to(torch.int32).contiguous()
            qp = qp.to(torch.int32)
            want = da.decode_attention_plain(q, k, v, qp, kp, window=win)
            got = da.decode_attention_cuda(q, k, v, qp, kp, window=win)
            e = (got.float() - want.float()).abs().max().item()
            check(e <= tol, f"decode_attention {dtype} {(B, S, H, Hkv, Dh, win, ring)}:"
                            f" max err {e} > {tol}")
            worst = max(worst, e) if dtype == torch.bfloat16 else worst
    err["decode_attention"] = worst
    frames_on_card_match_cpu()
    torch.cuda.synchronize()
    emit(phase="kernels", ok=True, max_abs_err=err)
    return err


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


def phase_serve(cfg):
    from repro_torch.core import framing, transports
    from repro_torch.kernels import ops
    from repro_torch.runtime import EngineService, encode_prompt

    n_clients, max_new = 12, 32
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
    check(all(n > 0 for n in launches.values()),
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
    pos = eng.state["pos"].clamp(max=eng.max_seq - 1)
    caches = eng.state["caches"]
    del eng, svc
    torch.cuda.empty_cache()
    return launches, (caches["k"][0].clone(), caches["v"][0].clone(), pos.clone())


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


# ---------------------------------------------------------------------------
# the kernels line
# ---------------------------------------------------------------------------

def kernels_line(cfg, launches, err, attn_inputs):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import mpk_guard as mg
    from repro_torch.models import kvcache

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tag = SEED & 0xFFFFFFFF
    rows = []

    def row(name, source, replaces, shape, ms, plain_ms, nbytes, ops, kind,
            library_ms, **extra):
        b, by = bound(nbytes, ops, kind)
        rows.append(dict(name=name, route="cuda", source=f"{SRC}/{source}",
                         replaces=replaces, launches=launches[name],
                         max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by, library_ms=library_ms,
                         shape=shape, **extra))

    def guard_times(n):
        p = _u32(n, gen)
        want = _word(mg.guard_copy_plain(p, tag, 0)[1])
        dst = torch.empty_like(p)
        it = 200 if n < 4096 else 50
        return (cuda_ms(lambda: mg.guard_copy_cuda(p, tag, want), it),
                cuda_ms(lambda: mg.guard_copy_plain(p, tag, want), max(5, it // 10)),
                cuda_ms(lambda: dst.copy_(p), it), 2 * n * 512 + 12, 2 * n * 128)

    # guard_copy: a request / response payload is one 512-byte row
    ms, pms, lib, nb, nops = guard_times(1)
    big = guard_times((64 << 20) // 512)
    bb, bby = bound(big[3], big[4], "fp32")
    row("guard_copy", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:93",
        "(1, 128) uint32", ms, pms, nb, nops, "fp32", lib,
        at_64MiB=dict(ms=big[0], plain_ms=big[1], library_ms=big[2],
                      bound_ms=bb, bound_by=bby))

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
    mask = (kp >= 0)[:, None, None, :]
    serve_err = (da.decode_attention_cuda(q, k, v, qp, kp).float()
                 - da.decode_attention_plain(q, k, v, qp, kp).float()).abs().max().item()
    check(serve_err <= 2e-2, f"decode_attention on the serving cache: {serve_err}")
    err = dict(err, decode_attention=max(err["decode_attention"], serve_err))
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), 200)
    row("decode_attention", "decode_attention.cu",
        "src/repro/kernels/decode_attention.py:71",
        f"q ({B}, 1, {H}, {Dh}) bf16, cache ({B}, {S}, {Hkv}, {Dh}), "
        f"{valid} valid rows", cuda_ms(lambda: da.decode_attention_cuda(
            q, k, v, qp, kp), 200),
        cuda_ms(lambda: da.decode_attention_plain(q, k, v, qp, kp), 50),
        nbytes, 4 * H * Dh * valid, "bf16", lib,
        valid_rows=valid)
    return rows


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
    cfg = get_config("llama3.2-1b")
    launches, attn_inputs = phase_serve(cfg)
    kernels = kernels_line(cfg, launches, err, attn_inputs)
    del attn_inputs
    torch.cuda.empty_cache()
    phase_parity(cfg)
    emit(phase="done", wall_s=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
