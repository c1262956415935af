#!/usr/bin/env python3
"""The PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. card    — name and power limit (nvidia-smi), and the build of every
             CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per
             source, in parallel).
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main paths' shapes and at edge cases (guard MACs bit-exact,
             each call twice after calls of many chunks, mac_batch at
             many-chunk shapes too, misaligned payloads refused; decode and
             flash attention at 2e-5 in f32 and 2e-2 in bf16, decode each
             call twice, with fully masked splits, one split, the long
             cache, Dh 80 with g = 5 and 6; flash attention at Dh 64, 80
             and 128 (g 6 at Dh 128: grok-1-314b's 48/8 heads) and its
             log-sum-exp; the flash backward against its plain version at
             1e-4 in f32 and 2e-2 in bf16, relative and absolute, Dh 64,
             80, 128, g 1, 4, 5, 6, lengths off its tiles,
             each call twice; the SSD scan at 1e-4 in f32 and 2e-2 in bf16,
             relative and absolute, with mamba2-1.3b's decays; the SSD
             backward the same way at mamba2's and zamba2's shapes, ragged
             lengths, an init state and a final-state gradient, G > 1,
             tiles of heads that leave a group's last tile short, each
             call twice; decode and flash attention and the flash backward
             also at whisper-tiny's exact shapes, non-causal over 1500
             frames, and decode over llava's full ring of 4096 with its
             window, in both dtypes).
             Then the repairs: attention and the SSD under grad run their
             forward and backward kernels, a backward through the decode
             kernel raises, and 70,000 one-row frames go through
             ``framing.mac_batch`` bit for bit.
   fabric  — the device fabric (``core.fabric``) as four ranks on the one
             card (``launch.world``: processes from the forkserver, each on
             ``cuda:0``, a gloo group; NCCL refuses two ranks on one GPU, so
             every exchange is staged through pinned host buffers): the
             guarded ``neighbor_exchange``, ``ring_all_gather``,
             ``reduce_scatter_ring`` and ``all_to_all`` at 64 MiB a rank (ok
             1 in every rank, results equal to the same computation in one
             rank, a flipped bit refused); ring attention at llama3.2-1b's
             attention shape, B 2, S 8192 (2048 a rank), bf16, causal,
             window 4096 and non-causal, against one flash call over the
             whole sequence (2e-2); mixtral-8x7b's MoE layer at full width
             expert-parallel (2 experts and 2048 tokens a rank) against the
             dense layer with routing groups of one rank's tokens (2e-2);
             llama3.2-1b's 16 blocks as a 4-stage GPipe pipeline, 4
             microbatches of 2 x 2048, forward and backward in bf16, against
             the stack in one rank (outputs 2e-2, gradient cosine >= 0.99);
             ``compressed_tree_reduce`` over one block's f32 gradient tree
             (60.8 M values) against the exact mean (within half an int8
             step, residual non-zero). Per case: wall ms, hops, staged bytes,
             launches of ``mac_batch``, ``flash_attention`` and
             ``flash_attention_bwd`` in the ranks (each exact); which gloo
             collectives take CUDA tensors; the rank starts and the wall.
   sharding — in the fabric's world: a full-width llama3.2-1b checkpoint
             (bf16, written by the port's ``Checkpointer``) placed by
             ``runtime.elastic.elastic_restore`` on a (2, 2) ("data",
             "model") mesh under ``fsdp_tp``, then on ``remesh(2, tp=2)``'s
             (1, 2) mesh (ranks 2 and 3 hold no shard): every rank's local
             shard equal, bit for bit, to the slice of the checkpoint's npz
             entry read apart from the restore, its shape ``local_shape``,
             its placements ``placements``; restore seconds, local bytes.
   ipc     — ``launch.ipc_wordcount`` on the card: the paper's word count
             through the port's six transports at 1e2 to 1e7 words (3
             reps, median) and uds, mpklink and mpklink_opt at 1e8 (1 rep):
             one line per transport and size (seconds, bytes, key syncs
             and guard-kernel launches a request, ``os.cpu_count()``).
             Every count exact, shm refusing >= 1e5 words with
             CapacityError, key syncs and launches equal to what the code
             gives (mpklink_opt <= 3 syncs), card-sealed regions equal to
             the CPU's frames bit for bit and a tampered region refused;
             claims 3 and 4 asserted, 1, 2 and 5 (timings) printed as
             PASS/FAIL lines; then 1 and 16 concurrent mpklink_opt
             sessions of 8 x 1e4 words through their rings (requests/s,
             wakeups and key syncs a request, p50/p99 of a batch).
3. prefill — ``runtime.steps.make_prefill_step`` at full width and depth
             (bf16, random weights from a seeded generator), 4 prompts of
             2048 tokens, for llama3.2-1b, mamba2-1.3b, zamba2-2.7b,
             olmo-1b, smollm-360m and qwen3-14b (40 layers, 29.5 GB), and
             2 prompts of 6144 tokens for mixtral-8x7b cut to 16 of its 32
             layers (46.4 GB; all 32 would not fit the card), so that the
             window of 4096 binds: ms per prefill, prompt tokens/s, peak
             memory, finite logits, mixtral's share of dropped (token,
             choice) pairs at its capacity factor of 1.25; the launch counts
             are zeroed just before and read just after and must equal one
             flash-attention launch per attention block and one SSD-scan
             launch per mamba block a call (llama 16, mamba2 48 SSD, zamba2
             54 SSD and 9 flash, olmo 16, smollm 32, qwen3 40, mixtral 16);
             then llava-next-mistral-7b at full depth (32 layers, 14.5 GB)
             over 2 prompts of 6144 tokens whose first 2880 positions are
             projected patch embeddings (32 flash a call, the window
             binds), grok-1-314b cut to 2 of its 64 layers (22.9 GB of
             bf16 weights; 48/8 heads of 128, 8 experts of d_ff 32768) at
             4 x 2048 (2 flash a call, its ``moe_drop_frac``), and
             whisper-tiny over 8 x 1500 frames and 8 x 448 tokens (12
             flash a call: 4 encoder, 4 self, 4 cross).
             Each prefill line carries the dry run of its own call
             (``launch.dryrun.count_step`` on the meta device, the kernels
             by their ``cost``): ``dry_state_bytes``, ``dry_flops``,
             ``dry_bound_ms`` (``roofline``: the larger of the compute and
             the memory term, and the memory term's bytes are an upper
             bound, every op's operands and results, so it is no floor),
             ``mfu`` (``model_flops`` over the measured ms at 989
             TFLOP/s), ``roofline_share`` (``dry_bound_ms`` over the
             measured ms) and ``compute_share`` (the compute term over
             the measured ms); its kernel launches a call times the calls
             must equal the measured launches.
             Then smollm-360m in the JAX package's padded 32/8 head layout
             (its weights embedded with zero pad rows) against the unpadded
             model in f32 at full depth: identical argmax, max abs
             difference printed.
4. serve   — llama3.2-1b at full width and depth (bf16), max_batch 8,
             max_seq 1024: 12 concurrent sessions of the port's
             ``MPKLinkOptTransport`` in front of ``EngineService.handler``
             (2 key syncs a request) and one batch envelope of 8 on
             ``serve_batch``, then a 100-word call's round trip through a
             transport of its own with the engine idle and ticking; then
             mamba2-1.3b, zamba2-2.7b, olmo-1b,
             smollm-360m, qwen3-14b, mixtral-8x7b (16 layers; max_seq
             1024 is inside its window, a dense cache),
             llava-next-mistral-7b and grok-1-314b (2 layers) with 8
             clients through the service step (``serve_frame``). Every request and response is a
             sealed frame; a tampered frame must be refused. The launch
             counts are zeroed just before and read just after; each kernel
             of the path must be > 0, and decode attention must launch once
             per attention block a tick.
   gateway — the north star's ``GatewayClient.call("infer", ...)``: the
             port's ``ServiceGateway("mpklink_opt", workers=2)`` with card
             regions in front of llama3.2-1b's engine (``infer``, bf16,
             max_batch 8, max_seq 1024), the word count (``wc``) and an
             allow-listed ``billing``; 12 clients' lockstep calls, a batch
             of 8, a scatter across infer and wc, then 12 coalesced
             callers (cohorts recorded in ``EngineService.cohorts``), each
             path's greedy tokens equal to ``serve_frame``'s with no
             gateway; decode attention once per attention block a tick;
             the guard launches and key syncs of the lockstep, batch and
             scatter envelopes equal to ``launch.gateway_bench``'s counts;
             the scatter twice under wc load, identical bits; refusals,
             each typed (a frame sealed under wc's channel sent to infer,
             a client with no billing key, a stale key after a
             revocation, a 1 ms budget against the ticking engine, one
             tampered item of a batch, the next frame off 16 bytes); two
             in-process replicas of wc, one drained under traffic, no lost
             call; ``greedy=False`` sampling with seeded CUDA generators.
             Printed, not asserted: requests/s and p50/p99 of calls at 1
             and 12 clients, direct and coalesced, and of a 100-word wc
             call with infer idle and ticking, beside ``os.cpu_count()``.
   copyplane — the legacy copy plane (``framing.ZERO_COPY = False``: pad
             and header concatenations, copies into the region or envelope,
             the two-launch MAC kernels ``mac_update_two_pass`` /
             ``mac_batch_two_pass``) beside the in-place one on ``cuda:0``:
             frames of the two planes bit-identical (64 KiB, 1 MiB, a
             padded size; batches too) and equal to the CPU's; one session
             interleaving the planes keeps its sequence; mpklink_opt
             through the gateway with the ``digest`` service at 64 KiB and
             1 MiB, k = 1 and 4, in both planes (digests right; 0
             concatenations a request in place, at least 1 in the legacy
             plane; every cell's guard launches exactly
             ``launch.gateway_bench``'s, the two-launch kernels only in the
             legacy plane). Printed, not asserted: requests/s, MiB/s,
             p50/p99, bytes copied a request, ``zero_copy_speedup``.
   examples — the seven ``repro_torch.examples`` at their default sizes
             on the card: six in this process (each's launch counts read
             around its ``main``), the fabric demo as a ``python -m``
             subprocess (its ranks re-import the main module). Each raises
             on a failed check, must end with its ``... OK`` line and
             launch its path's kernels; outputs in ``build/examples/``.
   proc    — every service in a process of its own (``core.procwire``,
             children from a forkserver, the slab shared through CUDA
             IPC): the word count at 1e2, 1e4 and 1e6 words (3 reps, each
             request's bits compared) over mpklink_opt_proc, mpklink_proc,
             shm_proc (refuses 1e6, CapacityError), rest and sockrpc:
             exact counts; key syncs and guard launches a request in the
             parent and in the child (its published launch words) equal
             to ``launch.ipc_wordcount``'s; a response sealed in the child
             equal, word for word, to the plain seal on the CPU. The
             paper's comparison, printed, not asserted: 16 clients of 1e4
             words, one session each, requests/s and p50/p99 for
             mpklink_opt_proc, rest and sockrpc and the mpklink/REST ratio.
             llama3.2-1b (full, bf16, max_batch 8, max_seq 1024) in two
             replica processes (``register_engine_fleet``) behind
             ``ServiceGateway("mpklink_opt")``: 12 clients' tokens equal
             the same seeded engine's through ``serve_frame`` in this
             process; decode attention once per attention block a tick in
             each child (``FLEET_STATS``). Then kill -9 of one child under
             4 client threads: every call correct or typed;
             ``FleetSupervisor(target=2)`` brings the replica back; tokens
             after the restart match; after close no ``mpkt_`` segment and
             no child is left. Last, ``ServiceGateway("mpklink_opt_proc")``
             (the gateway in its own child) under a FaultPlan of all eight
             kinds: every fault typed as expected, every wait bounded.
   decode  — uniform decode through ``make_decode_step`` (bf16, 8 rows,
             64 ticks): whisper-tiny from its encoder output and cross K/V
             built once (8 decode-attention launches a tick), llava at full
             depth with max_seq 32768 on a ring cache filled as a wrapped
             ring (32 a tick): ms per tick beside the floor, the state's
             bytes beside the dense cache's. Then llava at 2 layers in f32:
             4352 tokens decoded on the ring (it wraps) against the forward
             with the window, identical argmax where decided, within 3e-4.
5. train   — the port's ``Trainer`` at full width and depth for llama,
             mamba2, zamba2, olmo-1b and smollm-360m: f32 parameters and
             AdamW moments, bf16 compute, 8 x 2048 tokens a step in
             microbatches of 2 (zamba2: 1, the largest that fits), 6 steps
             at lr 3e-4 (2 warmup) on the synthetic stream: every loss, ms
             per step and tokens/s after the first step, peak memory; the
             loss must fall and each attention and mamba block of each
             microbatch must launch its kernel's forward and backward once
             (llama 384 flash; mamba2 1152 SSD; zamba2 2592 SSD and 432
             flash; olmo 384 flash; smollm 768 flash); whisper-tiny the
             same at 8 x 448 tokens over 1500 frames (288 flash: 12 a
             microbatch). Then the four whose state does not fit at full
             depth, cut to ``chip_smoke.py``'s constants, 4 steps each:
             qwen3-14b (4 of 40 layers, f32, 46.0 GB of state) at 8 x 2048
             in microbatches of 2; mixtral-8x7b (2 of 32, f32, 50.6 GB)
             and llava-next-mistral-7b (12 of 32, f32, 46.1 GB, 2880 patch
             embeddings a row) at 2 x 6144 in microbatches of 1 (the
             window binds), with remat; grok-1-314b (1 of 64) with bf16
             parameters and moments (``launch.dryrun.TRAIN_PARAM_DTYPE`` /
             ``TRAIN_OPT_DTYPE``, 52.2 GB) at 2 x 2048 in one microbatch,
             with remat. Each line prints the dtypes, remat and the bytes
             of state; under remat the forward kernels launch twice a
             block and microbatch (the recompute), the backward once; the
             peak must stay under 80 GB. Every train line carries the dry
             run of its own step as the prefill lines do, plus
             ``dry_act_bytes`` (one microbatch's saved activations) and
             ``dry_state_plus_act_gb`` beside the measured peak;
             ``dry_state_bytes`` must equal ``state_bytes``, and each cut
             depth must be at most the dry run's ``dry_fits_depth`` of
             the published model on this card. Then remat itself: llama3.2-1b
             one step of 8 x 2048 each way from the same state (losses,
             peaks, launches) and the first microbatch's gradients each
             way (equal bit for bit; the remat peak must be lower), the
             same for mixtral-8x7b (2 of 32 layers, one step of 1 x 4224:
             the window binds and the MoE routing is recomputed; the
             state and gradients set its peak, so it is printed only), and
             zamba2-2.7b 2 steps in microbatches of 2
             with remat (its peak beside microbatch 1 without it). Then
             one 1 x 512 microbatch for llama, mamba2, olmo-1b, qwen3-14b
             (2 layers) and grok-1-314b (1 layer; the f32 gradients kept
             on the host), 1 x 448 for whisper and 1 x 4224 for
             mixtral-8x7b (2 layers, the window binds): loss and gradients
             through the kernels in bf16 against the plain versions in f32
             (loss to 2e-2 relative, every gradient leaf at cosine >= 0.99).
6. parity  — in f32 at full width: the llama engine with the decode-attention
             kernel and with its plain version give identical greedy tokens;
             the reduced engine on the card equals it on the CPU; and for
             the three families and whisper-tiny at full depth, and
             olmo-1b, smollm-360m, qwen3-14b, mixtral-8x7b and llava at 2
             layers and grok-1-314b at 1 (26 GB of f32 weights), the
             forward with the kernels equals the forward with
             the plain versions (mixtral's and llava's over 4224 tokens,
             past the window, llava's with its vision prefix), and the
             last prefill logits equal ``decode_step`` run token by token
             over the same prompt (identical argmax, max abs difference printed; mixtral
             at a capacity factor of E / k, where neither path drops).

Then a ``kernels`` JSON line (times from CUDA events, bounds from this
run's inputs, launches summed over the fabric (its ranks'), ipc, prefill,
serve, gateway, copyplane, examples, proc (the parent's and the
children's), decode and train phases; ``mac_batch_two_pass`` and
``mac_update_two_pass``, the legacy copy plane's MAC kernels, are rows of
their own, with ``at_copyplane_*`` beside the one-launch kernel at the
copyplane phase's 1 MiB shapes; the flash and SSD rows add ``earlier_ms``, the CUDA-core design they
replaced timed in this run, and the two backwards the design each replaced
(flash: ``mma.sync``; SSD: the per-head chunk kernel, also
``earlier_pass_ms``); the four add ``kernels_per_call``, the kernel
nodes of a CUDA graph that captures the call (1, 3, 3 and 6), ``pass_ms`` (the flash backward's
from the profiler's device times), ``at_dh80`` for both flash rows
(zamba2-2.7b's attention), ``at_qwen3`` and ``at_mixtral`` for the forward
(4 x 2048, 40/8 heads of 128; 2 x 6144, 32/8 heads with the window of
4096) and ``at_grok`` (4 x 2048, 48/8 heads of 128) for the forward,
``at_olmo`` (2 x 2048, 16 heads of 128, MHA), ``at_qwen3`` (2 x 2048,
40/8 of 128), ``at_mixtral`` (1 x 6144, 32/8 of 128, window 4096; SDPA's
backward with the same pairs as a boolean mask) and ``at_grok`` (2 x
2048, 48/8 of 128) for the backward, and
``tensor_core_instr``, the HGMMA/HMMA
instructions in the SASS of their bf16 kernels (the flash backward's must
be HGMMA); the SSD backward's row adds its ``heads_per_tile``; the decode-attention, guard_copy, mac_batch and mac_update
rows add ``earlier_ms`` and ``earlier_graph_ms``, the two-launch designs
they replaced, ``graph_ms``, ms per call under CUDA-graph replay (outputs
checked against the eager calls bit for bit), and ``kernels_per_call``
counted the same way (must be 1); decode attention adds
``at_full_cache``, 16 layer caches of (8, 1024, 8, 64) called in turn,
``at_qwen3_cache``, qwen3-14b's 40 layer caches of (8, 1024, 8, 128) with
40 query heads, ``at_long_cache``, one (8, 16384, 8, 64) cache,
``at_whisper_cross_cache``, whisper's 4 cross caches of (8, 1500, 6, 64)
non-causal, and ``at_llava_ring``, llava's 32 full rings of (8, 4096, 8,
128) with the window, all cold in L2; the flash forward adds
``at_whisper_enc`` (8, 1500, 6/6, 64) and ``at_whisper_cross`` (448 over
1500 frames), both non-causal, and the backward ``at_whisper_cross``
(2 x 448 over 1500);
guard_copy adds ``at_64MiB``; mac_update ``at_65536_rows`` and mac_batch
``at_32MiB``, 4 distinct 32 MiB inputs called in turn, cold in L2, eager
and under graph replay), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device": {...}}``.
Imports neither JAX nor the ``repro`` package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the H100 SXM's peaks and the least time of a piece of work: one set, the
# port's roofline's (a checkout without src/ fails here, printing nothing)
from repro_torch.roofline import HBM_BW, PEAK_FLOPS, bound  # noqa: E402

SEED = 0x5EED1234
SRC = "src/repro_torch/kernels/csrc"
# zamba2-2.7b's training microbatch: the largest that fits the card's 80 GB
# beside f32 parameters, gradients and AdamW moments (~38.7 GB); see PERF.md
ZAMBA_MICRO = 1
# mixtral-8x7b's depth on one card: 16 of its 32 layers are 46.4 GB of bf16
# weights (all 32: 93 GB, more than the card's 80)
MIXTRAL_LAYERS = 16
# training depths on one card (bytes of state: parameters, gradients and
# two AdamW moments, launch.train.train_bytes_per_param times param_count;
# each at most launch.dryrun.fits_depth, which phase_train checks):
# qwen3-14b 4 of 40 layers, f32, 46.0 GB (all 40: 236 GB)
QWEN3_TRAIN_LAYERS = 4
# mixtral-8x7b 2 of 32, f32, 50.6 GB (3 would be 73.9 GB before activations)
MIXTRAL_TRAIN_LAYERS = 2
# llava-next-mistral-7b 12 of 32, f32, 46.1 GB (all 32: 116 GB)
LLAVA_TRAIN_LAYERS = 12
# grok-1-314b 1 of 64, bf16 parameters, gradients and moments, 52.2 GB
# (a layer is 4.92 G parameters, the embeddings and head 1.61 G)
GROK_TRAIN_LAYERS = 1
# grok-1-314b served and prefilled: 2 of 64 layers, 22.9 GB of bf16 weights
GROK_SERVE_LAYERS = 2
# the JAX package's padded head layout for smollm-360m (launch/dryrun.py)
SMOLLM_PADS = dict(pad_q_heads=32, pad_kv_heads=8)
# whisper-tiny's published text context: its decoder's prompts and cache
WHISPER_TEXT = 448


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


def kernels_per_call(fn, n=3):
    """Device kernels per call of ``fn``: after an eager warm-up on the
    capture stream (which makes the kernels' workspaces), ``n`` calls are
    captured in one CUDA graph and its kernel nodes are counted through the
    driver API (copies and memsets are nodes of other types). The count is
    read from the graph itself, so it holds every kernel the calls launch;
    ``torch.profiler``, which counted them before, lost records now and
    then (a three-kernel call once read 2.3)."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    driver = ctypes.CDLL("libcuda.so.1")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(driver.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(driver.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        check(driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kernels += kind.value == 0              # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels / n


def kernel_ms(fn, n=10):
    """Device ms per call of each kernel that ``fn`` launches, by name
    (``torch.profiler``, ``n`` calls after one the profiler discards)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return {e.key: e.self_device_time_total / 1e3 / n for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset", "ProfilerStep"))}


def short_names(times, names):
    """``times`` keyed by the first of ``names`` that each kernel's name
    contains (C++ kernel names carry templates and namespaces)."""
    out = {}
    for key, ms in times.items():
        for name in names:
            if name in key:
                out[name] = out.get(name, 0.0) + ms
                break
    return out


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


def _stack(frames, rows, gen):
    """Random (frames, rows, 128) uint32 words."""
    return _u32(frames * rows, gen).view(frames, rows, 128)


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = check_guard_macs(gen)
    err["decode_attention"] = check_decode(gen)
    err["flash_attention"] = check_flash(gen)
    err["flash_attention_bwd"] = check_flash_bwd(gen)
    err["ssd_scan"] = check_ssd(gen)
    err["ssd_scan_bwd"] = check_ssd_bwd(gen)
    frames_on_card_match_cpu()
    repairs = check_repairs(gen)
    torch.cuda.synchronize()
    emit(phase="kernels", ok=True, max_abs_err=err, repairs=repairs)
    return err


def check_guard_macs(gen):
    """The guard MAC family bit for bit against the plain versions, after
    calls of many chunks have used the arrival counters, each call twice
    (the counters are back at 0) and the earlier two-pass kernels too:
    guard_copy and mac_update at rows 0, 1, 7, 63, 64, 65, 256, 65536 and
    64 MiB (mac_update one-shot and over three splits chained from
    mac_init_state, ending in mac_finalize); mac_batch at 16 frames of 0 to
    64 rows (one chunk) and of 65, 256, 1024 and 5000 rows, and 200 frames
    of 700 rows (many chunks, one counter a frame); misaligned payloads
    refused. → max_abs_err 0 for each."""
    from repro_torch.kernels import mpk_guard as mg

    tag = SEED & 0xFFFFFFFF
    big = _u32((64 << 20) // 512, gen)
    h0 = mg.mac_init_state_cuda(tag, "cuda")
    check(_same(h0, mg.mac_init_state_plain(tag, "cuda")), "mac_init_state differs from plain")
    mg.guard_copy_cuda(big, tag, 0)
    mg.mac_update_cuda(h0, big)
    mg.mac_batch_cuda(big.view(8, -1, 128), tag)
    updates = (mg.mac_update_cuda, mg.mac_update_cuda, mg._mac_update_two_pass)
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
        whole = mg.mac_update_plain(h0, p)
        for update in updates:
            check(_same(update(h0, p), whole), f"{update.__name__} rows={rows} differs from plain")
        h = h0
        for a, b in ((0, rows // 3), (rows // 3, rows // 3), (rows // 3, rows)):
            step = mg.mac_update_plain(h, p[a:b])
            for update in updates:
                check(_same(update(h, p[a:b]), step),
                      f"{update.__name__} rows {a}:{b} of {rows} differs from plain")
            h = step
        check(_same(h, whole), f"split mac_update rows={rows} != one-shot")
        fin = mg.mac_finalize_cuda(h)
        check(_word(fin) == _word(mg.mac_finalize_plain(h)) == want,
              f"split mac_update rows={rows} != one-shot MAC")

    cases = [(16, rows) for rows in (0, 1, 2, 7, 33, 64, 65, 256, 1024, 5000)] + [(200, 700)]
    for frames, rows in cases:
        st = _stack(frames, rows, gen)
        want = mg.mac_batch_plain(st, tag)
        for batch in (mg.mac_batch_cuda, mg.mac_batch_cuda, mg._mac_batch_two_pass):
            check(_same(batch(st, tag), want),
                  f"{batch.__name__} ({frames}, {rows}) differs from plain")
    refuses(lambda: mg.guard_copy_cuda(misaligned(big[:1]), tag, 0), "guard_copy")
    refuses(lambda: mg.mac_update_cuda(h0, misaligned(big[:300])), "mac_update")
    refuses(lambda: mg.mac_batch_cuda(misaligned(big[:600]).view(2, 300, 128), tag),
            "mac_batch")
    del big
    return dict.fromkeys(("guard_copy", "mac_init_state", "mac_update", "mac_finalize",
                          "mac_batch", "mac_batch_two_pass", "mac_update_two_pass"), 0)

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
    cache; Dh 80 with g = 5 and 6 (40/8, 30/5, 48/8 heads); whisper's cross
    cache (non-causal, 1500 rows) and self cache, llava's full ring. Each
    call twice on the same inputs (identical: the arrival counters are back
    at 0), and the earlier two-launch design checked too. → the worst bf16
    error."""
    from repro_torch.kernels import decode_attention as da
    cases = [  # B, S, H, Hkv, Dh, window, layout, lens, n_split (None: any), causal
        (8, 1024, 32, 8, 64, None, "lens", None, None, True),
        (8, 1024, 32, 8, 64, 256, "lens", None, None, True),
        (4, 1000, 32, 8, 64, 128, "ring", None, None, True),
        (2, 77, 16, 2, 128, None, "lens", None, None, True),
        (3, 300, 8, 1, 128, 32, "lens", None, None, True),
        (2, 4096, 8, 2, 64, None, "lens", [1000, 3], ">1", True),
        (3, 700, 12, 4, 64, None, "lens", [0, 1, 700], None, True),
        (4, 1000, 40, 8, 80, None, "lens", None, None, True),
        (3, 777, 30, 5, 80, 128, "lens", [777, 1, 400], None, True),
        (2, 500, 48, 8, 80, None, "ring", None, None, True),
        (64, 1024, 32, 8, 64, None, "lens", None, "1", True),
        (8, 16384, 32, 8, 64, None, "lens", [16384] * 8, ">1", True),
        # the new main paths' exact shapes: whisper-tiny's cross cache (1500
        # rows, off the 64-row tile) non-causal and its self cache of 448,
        # llava's full ring of 4096 with its window of 4096
        (8, 1500, 6, 6, 64, None, "lens", [1500] * 8, None, False),
        (8, 448, 6, 6, 64, None, "lens", None, None, True),
        (8, 4096, 32, 8, 128, 4096, "ring", None, None, True),
    ]
    worst = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for B, S, H, Hkv, Dh, win, layout, lens, splits, causal in cases:
            case = (B, S, H, Hkv, Dh, win, layout, causal, str(dtype))
            q, k, v, qp, kp = decode_inputs(gen, B, S, H, Hkv, Dh, dtype, layout, lens)
            n_split = da.split_plan(B, S, Hkv, da._slots(0, dtype, Dh, H // Hkv))[1]
            check(splits is None or (n_split > 1 if splits == ">1" else n_split == 1),
                  f"decode_attention {case}: the plan has {n_split} splits")
            mode = dict(causal=causal, window=win)
            want = da.decode_attention_plain(q, k, v, qp, kp, **mode)
            got = da.decode_attention_cuda(q, k, v, qp, kp, **mode)
            again = da.decode_attention_cuda(q, k, v, qp, kp, **mode)
            earlier = da._decode_attention_split_merge(q, k, v, qp, kp, **mode)
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
    """A contiguous copy of ``t`` whose start is one element (2 bytes in
    bf16, 4 in uint32) off 16-byte alignment."""
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
    fall inside tiles; Dh 80 (g = 2, 4, 5, 6, 1) with the same variety. The
    log-sum-exp written for training against the plain version's (10 x the
    tolerance; dead rows NEG_INF in both). → the worst bf16 error."""
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
        (2, 700, 700, 16, 4, 80, True, 128, 3, 0, "ordered"),
        (2, 300, 1000, 8, 8, 80, False, None, 37, 5, "ordered"),
        (2, 257, 257, 10, 2, 80, True, None, 3, 2, "ordered"),
        (2, 190, 600, 12, 2, 80, False, 70, 0, 3, "perm"),
        (3, 1, 333, 5, 1, 80, True, 64, 3, 0, "ordered"),
        # g = 6 at Dh 128 (grok-1-314b's 48/8 heads), with and without a window
        (2, 257, 257, 12, 2, 128, True, None, 3, 2, "ordered"),
        (1, 300, 300, 6, 1, 128, True, 100, 0, 0, "ordered"),
        # whisper-tiny's encoder and cross-attention (non-causal, 1500 frames
        # off the tiles) and its decoder's self-attention, at their shapes
        (8, 1500, 1500, 6, 6, 64, False, None, 0, 0, "ordered"),
        (8, 448, 1500, 6, 6, 64, False, None, 0, 0, "ordered"),
        (8, 448, 448, 6, 6, 64, True, None, 0, 0, "ordered"),
    ]
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for B, Sq, Skv, H, Hkv, Dh, causal, win, tail, pad, layout in cases:
            q, k, v, qp, kp = flash_inputs(gen, B, Sq, Skv, H, Hkv, Dh, dtype, tail,
                                           layout)
            if pad:
                qp[:, -pad:] = -2
            got = fa.flash_attention_cuda(q, k, v, qp, kp, causal=causal, window=win)
            want, lse_w = fa.flash_attention_plain(q, k, v, qp, kp, causal=causal,
                                                   window=win, return_lse=True)
            e = (got.float() - want.float()).abs().max().item()
            case = (B, Sq, Skv, H, Hkv, Dh, causal, win, tail, pad, layout, str(dtype))
            check(e <= tol, f"flash_attention {case}: max err {e} > {tol}")
            # with the log-sum-exp (training): the same output, the plain's lse
            got2, lse = fa.flash_attention_cuda(q, k, v, qp, kp, causal=causal,
                                                window=win, return_lse=True)
            check(torch.equal(got2, got), f"flash_attention {case}: writing lse "
                  f"changed the output")
            dead = lse_w <= -1e29
            check(torch.equal(lse <= -1e29, dead),
                  f"flash_attention {case}: lse marks other rows dead than plain")
            le = (lse - lse_w)[~dead].abs().max().item() if (~dead).any() else 0.0
            check(le <= 10 * tol, f"flash_attention {case}: lse err {le}")
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


def check_flash_bwd(gen):
    """The backward kernel against ``flash_attention_bwd_plain`` on the
    forward kernel's own output and log-sum-exp, each call twice (identical:
    no atomics), |got - want| <= tol·(1 + |want|) for dq, dk and dv with tol
    1e-4 in f32 and 2e-2 in bf16: Dh 64, 80 and 128, g 1, 4 and 5, causal
    with and without a window, non-causal, ragged Sq != Skv, q_pos < 0 rows
    (dq 0) and kv_pos < 0 keys (dk = dv = 0), the training shape
    (2, 2048, 32/8, 64), and Sq and Skv off the bf16 design's 128- and
    64-row tiles (one query row, 65 over 127, 383, 191 over 64). A
    misaligned dO is refused. → the worst bf16 error."""
    from repro_torch.kernels import flash_attention as fa
    cases = [  # B, Sq, Skv, H, Hkv, Dh, causal, window, tail, padded q rows
        (2, 2048, 2048, 32, 8, 64, True, None, 0, 0),
        (2, 256, 256, 4, 4, 64, True, None, 0, 0),
        (2, 300, 300, 8, 2, 64, True, 100, 3, 2),
        (1, 200, 333, 10, 2, 80, True, None, 5, 3),
        (2, 190, 190, 5, 1, 80, True, 64, 0, 0),
        (2, 129, 70, 4, 4, 80, False, None, 3, 0),
        (1, 257, 300, 8, 2, 128, True, None, 3, 2),
        (2, 128, 200, 4, 4, 128, False, None, 7, 0),
        (1, 150, 150, 5, 1, 128, True, 50, 0, 4),
        # off the wgmma design's tiles (128 resident rows, 64 streamed)
        (2, 200, 333, 8, 8, 64, True, None, 5, 3),
        (1, 65, 127, 12, 4, 64, False, 50, 0, 0),
        (1, 383, 383, 10, 2, 80, True, 100, 3, 1),
        (1, 1, 129, 4, 1, 128, True, None, 0, 0),
        (2, 191, 64, 4, 4, 128, False, None, 1, 2),
        # g = 6 at Dh 128 (grok-1-314b's 48/8 heads), with and without a window
        (1, 257, 257, 12, 2, 128, True, None, 3, 2),
        (1, 300, 300, 6, 1, 128, True, 100, 0, 0),
        # whisper-tiny's training microbatch: cross (448 over 1500) and
        # encoder attention non-causal, decoder self-attention causal
        (2, 448, 1500, 6, 6, 64, False, None, 0, 0),
        (2, 1500, 1500, 6, 6, 64, False, None, 0, 0),
        (2, 448, 448, 6, 6, 64, True, None, 0, 0),
    ]
    worst = 0.0
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for B, Sq, Skv, H, Hkv, Dh, causal, win, tail, pad in cases:
            case = (B, Sq, Skv, H, Hkv, Dh, causal, win, tail, pad, str(dtype))
            q, k, v, qp, kp = flash_inputs(gen, B, Sq, Skv, H, Hkv, Dh, dtype, tail)
            if pad:
                qp[:, -pad:] = -2
            out, lse = fa.flash_attention_cuda(q, k, v, qp, kp, causal=causal,
                                               window=win, return_lse=True)
            dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            args = (q, k, v, out, lse, dout, qp, kp)
            got = fa.flash_attention_bwd_cuda(*args, causal=causal, window=win)
            again = fa.flash_attention_bwd_cuda(*args, causal=causal, window=win)
            want = fa.flash_attention_bwd_plain(*args, causal=causal, window=win)
            for name, g_, a_, w_ in zip(("dq", "dk", "dv"), got, again, want):
                check(torch.equal(g_, a_), f"flash_attention_bwd {case}: a second "
                      f"call's {name} differs")
                g32, w32 = g_.float(), w_.float()
                excess = ((g32 - w32).abs() - tol * (1 + w32.abs())).max().item()
                check(excess <= 0, f"flash_attention_bwd {case}: {name} over "
                      f"tolerance by {excess}")
                check(bool(torch.isfinite(g32).all()), f"flash_attention_bwd {case}: "
                      f"non-finite {name}")
                if dtype == torch.bfloat16:
                    worst = max(worst, (g32 - w32).abs().max().item())
            if pad:
                check(got[0][:, -pad:].abs().max().item() == 0.0,
                      f"flash_attention_bwd {case}: a q_pos < 0 row has a gradient")
            if tail:
                check(got[1][:, -tail:].abs().max().item() == 0.0
                      and got[2][:, -tail:].abs().max().item() == 0.0,
                      f"flash_attention_bwd {case}: a kv_pos < 0 key has a gradient")
            del q, k, v, out, lse, dout, got, again, want
    q, k, v, qp, kp = flash_inputs(gen, 1, 64, 64, 4, 2, 64, torch.bfloat16, 0)
    out, lse = fa.flash_attention_cuda(q, k, v, qp, kp, return_lse=True)
    refuses(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, misaligned(out), qp, kp),
            "flash_attention_bwd")
    return worst


def check_repairs(gen):
    """No gradient is dropped and no batch is refused: ops.attention and
    ops.ssd under grad mode go through FlashAttention and SSDScan (a
    grad_fn, one forward and one backward launch each, a finite gradient);
    ops.decode_attention on CUDA inputs that require grad raises; and
    70,000 one-row frames through ``framing.mac_batch`` (more than one
    launch's 65,535) equal the CPU's MACs bit for bit."""
    from repro_torch.core import framing
    from repro_torch.kernels import mpk_guard as mg
    from repro_torch.kernels import ops

    q, k, v, qp, kp = flash_inputs(gen, 1, 128, 128, 4, 2, 64, torch.bfloat16, 0)
    q.requires_grad_(True)
    ops.LAUNCHES.reset()
    out = ops.attention(q, k, v, qp, kp)
    check(out.grad_fn is not None, "ops.attention under grad has no grad_fn")
    out.float().sum().backward()
    n = ops.LAUNCHES.snapshot()
    check(n["flash_attention"] == 1 and n["flash_attention_bwd"] == 1
          and q.grad is not None and bool(torch.isfinite(q.grad).all()),
          f"the differentiable attention did not run its two kernels: {n}")
    x, dt, A_log, Bm, Cm, D = ssd_inputs(gen, 1, 256, 8, 64, 1, 128, torch.bfloat16)
    x.requires_grad_(True)
    ops.LAUNCHES.reset()
    y, _ = ops.ssd(x, dt, A_log, Bm, Cm, D)
    check(y.grad_fn is not None, "ops.ssd under grad has no grad_fn")
    y.float().sum().backward()
    ns = ops.LAUNCHES.snapshot()
    check(ns["ssd_scan"] == 1 and ns["ssd_scan_bwd"] == 1 and x.grad is not None
          and bool(torch.isfinite(x.grad).all()),
          f"the differentiable SSD did not run its two kernels: {ns}")
    try:
        ops.decode_attention(q[:, :1].detach().requires_grad_(True), k, v, qp[:, :1], kp)
        raised = False
    except RuntimeError as e:
        raised = "no backward" in str(e)
    check(raised, "a backward through the decode_attention kernel did not raise")
    check(ops.LAUNCHES.snapshot()["decode_attention"] == 0,
          "a refused decode-attention call launched")
    frames = 70_000
    words = _u32(frames, gen)
    on_card = framing.mac_batch(list(words.view(frames, 1, 128).unbind(0)), SEED)
    host = words.cpu()
    on_cpu = framing.mac_batch(list(host.view(frames, 1, 128).unbind(0)), SEED)
    check(frames > mg.MAX_BATCH_FRAMES and on_card == on_cpu,
          "framing.mac_batch over 70,000 frames differs from the CPU")
    return dict(decode_backward_raises=True,
                attention_grad_launches=n["flash_attention_bwd"],
                ssd_grad_launches=ns["ssd_scan_bwd"], mac_batch_frames=frames)


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


def check_ssd_bwd(gen):
    """The SSD backward's kernels against ``ssd_scan_bwd_plain`` on the same
    inputs, |got - want| <= tol·(1 + |want|) for every gradient with tol
    1e-4 in f32 and 2e-2 in bf16, each case twice (identical bits: the sums
    over heads and chunks run in a fixed order): mamba2-1.3b's training
    microbatch (2, 2048, 64, 64, N 128) and decays, zamba2-2.7b's heads
    (80 of 64, N 64), lengths that are not chunk multiples, one step, an
    init_state and a final-state gradient, G > 1, chunks of 32 and 64, and
    shapes whose planned tiles of heads leave a group's last tile short
    (24 heads in tiles of 5; 3 in tiles of 2) or take one head a tile (at
    least two short ones, checked). → the worst bf16 absolute error."""
    from repro_torch.kernels import ssd_scan as ss
    cases = [  # B, S, H, P, G, N, Q, init, d final
        (2, 2048, 64, 64, 1, 128, 128, False, False),
        (1, 2048, 80, 64, 1, 64, 128, False, False),
        (2, 1000, 16, 64, 4, 128, 128, True, True),
        (1, 77, 8, 32, 2, 64, 64, False, True),
        (2, 300, 16, 64, 2, 64, 128, True, False),
        (2, 1, 16, 64, 2, 128, 128, True, True),
        (2, 300, 8, 32, 1, 32, 128, False, True),
        (1, 200, 16, 64, 4, 32, 32, True, True),
        # the bf16 chunk kernel's tiles of heads, as bwd_heads_per_tile plans
        # them on 132 SMs: 24 heads a group in tiles of 5, 5, 5, 5 and 4,
        # with decays exp(-dt·1) .. exp(-dt·24) summed in one Σ M; 12 heads
        # in 4 groups of 3, tiles of 2 and 1; one head a tile
        (2, 400, 24, 64, 1, 128, 32, False, True),
        (1, 2048, 12, 64, 4, 64, 128, True, True),
        (1, 190, 12, 32, 1, 32, 64, True, False),
    ]
    names = ("dx", "ddt", "dA_log", "dB", "dC", "dD", "d_init")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ragged = [c for c in cases
              if (c[2] // c[4]) % ss.bwd_heads_per_tile(c[0], c[1], c[2], c[4], c[6], sms)]
    check(len(ragged) >= 2, f"ssd_scan_bwd: the cases plan {len(ragged)} groups whose "
          f"last tile of heads is short on {sms} SMs, want 2")
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for B, S, H, P, G, N, Q, init, dfin in cases:
            case = (B, S, H, P, G, N, Q, init, dfin, str(dtype))
            x, dt, A_log, Bm, Cm, D = ssd_inputs(gen, B, S, H, P, G, N, dtype)
            s0 = (torch.randn((B, H, P, N), generator=gen, device="cuda")
                  if init else None)
            dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
            df = (torch.randn((B, H, P, N), generator=gen, device="cuda")
                  if dfin else None)
            args = (x, dt, A_log, Bm, Cm, D, s0, dy, df)
            got = ss.ssd_scan_bwd_cuda(*args, chunk=Q)
            again = ss.ssd_scan_bwd_cuda(*args, chunk=Q)
            want = ss.ssd_scan_bwd_plain(*args, chunk=Q)
            for name, g_, a_, w_ in zip(names, got, again, want):
                if w_ is None:
                    check(g_ is None, f"ssd_scan_bwd {case}: {name} without an init")
                    continue
                check(g_.dtype == w_.dtype and g_.shape == w_.shape,
                      f"ssd_scan_bwd {case}: {name} {g_.dtype} {tuple(g_.shape)}")
                check(torch.equal(g_, a_), f"ssd_scan_bwd {case}: a second call's "
                      f"{name} differs")
                g32, w32 = g_.float(), w_.float()
                check(bool(torch.isfinite(g32).all()) and bool(torch.isfinite(w32).all()),
                      f"ssd_scan_bwd {case}: non-finite {name}")
                excess = ((g32 - w32).abs() - tol * (1 + w32.abs())).max().item()
                check(excess <= 0, f"ssd_scan_bwd {case}: {name} over tolerance by "
                      f"{excess}")
                if dtype == torch.bfloat16:
                    worst = max(worst, (g32 - w32).abs().max().item())
            del x, dy, got, again, want
    x, dt, A_log, Bm, Cm, D = ssd_inputs(gen, 1, 64, 8, 64, 1, 128, torch.bfloat16)
    refuses(lambda: ss.ssd_scan_bwd_cuda(x, dt, A_log, Bm, Cm, D, None, misaligned(x),
                                         chunk=64), "ssd_scan_bwd")
    torch.cuda.empty_cache()
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


def layer_kernels(cfg):
    """{kernel: launches per forward} of a model's layer stack: flash
    attention once per attention block (every layer of a dense, VLM or MoE
    model, each insertion of a hybrid's shared block; an encoder-decoder's
    encoder layers and its decoder's self and cross blocks), the SSD scan
    once per mamba block."""
    L = cfg.num_layers
    n_attn = {"dense": L, "vlm": L, "moe": L, "ssm": 0, "audio": cfg.enc_layers + 2 * L,
              "hybrid": L // max(1, cfg.attn_every)}[cfg.family]
    n_ssd = L if cfg.family in ("ssm", "hybrid") else 0
    return {k: n for k, n in (("flash_attention", n_attn), ("ssd_scan", n_ssd)) if n}


def decode_blocks(cfg):
    """Decode-attention launches a tick: one per attention block of the
    decoder (an encoder-decoder's self and cross blocks both)."""
    if cfg.enc_dec:
        return 2 * cfg.num_layers
    return layer_kernels(cfg).get("flash_attention", 0)


def model_batch(cfg, B, S, gen, dtype=torch.bfloat16):
    """B random prompts of S tokens, and the inputs the model's family
    adds, 0.1·N(0, 1) as the synthetic data draws them: a VLM's patch
    embeddings (B, vision_tokens, vision_dim), an encoder-decoder's frames
    (B, enc_ctx, D)."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda")}
    if cfg.vision_tokens:
        batch["vision_embeds"] = (0.1 * torch.randn(
            (B, cfg.vision_tokens, cfg.vision_dim), generator=gen, device="cuda")).to(dtype)
    if cfg.enc_dec:
        batch["frames"] = (0.1 * torch.randn((B, cfg.enc_ctx, cfg.d_model),
                                             generator=gen, device="cuda")).to(dtype)
    return batch


def phase_prefill(cfg, n_calls=3, B=4, S=2048):
    """``make_prefill_step`` at full width and depth in bf16 over B prompts
    of S tokens; each kernel of ``layer_kernels`` must launch its count
    per call. For an MoE model, one more forward after the count reads
    the share of (token, choice) pairs its layers dropped."""
    from repro_torch.kernels import ops
    from repro_torch.models import Impl, forward, init_params
    from repro_torch.models.layers import padded_vocab
    from repro_torch.runtime.steps import make_prefill_step

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                         dtype=torch.bfloat16)
    step = make_prefill_step(cfg, Impl(), dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    batch = model_batch(cfg, B, S, gen)
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
    for kernel, per_call in layer_kernels(cfg).items():
        check(launches[kernel] == per_call * n_calls,
              f"{cfg.name} prefill: {launches[kernel]} {kernel} launches in "
              f"{n_calls} calls, want {per_call} per call")
    check(logits.shape == (B, 1, padded_vocab(cfg.vocab_size))
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          f"{cfg.name} prefill: logits {tuple(logits.shape)} not finite")
    ms = wall / n_calls * 1e3
    extra = {}
    if cfg.moe:
        with torch.no_grad():
            _, aux = forward(cfg, params, batch, dtype=torch.bfloat16, last_only=True)
        extra = dict(capacity_factor=cfg.moe.capacity_factor,
                     moe_drop_frac=aux["moe_drop_frac"].item() / cfg.num_layers)
    if cfg.vision_tokens:
        extra["vision_tokens"] = cfg.vision_tokens
    if cfg.enc_dec:
        extra.update(enc_layers=cfg.enc_layers, frames=cfg.enc_ctx)
    extra.update(dry_run(cfg, "prefill", B, S, ms, launches, n_calls, impl=Impl()))
    emit(phase="prefill", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype="bfloat16", batch=B, prompt_len=S,
         window=cfg.swa_window, calls=n_calls, ms_per_prefill=ms,
         prompt_tokens_per_s=B * S / ms * 1e3,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, logits_finite=True, **extra)
    del params, batch, logits
    torch.cuda.empty_cache()
    return launches


def pad_heads(cfg, cfg_pad, attn):
    """A stacked attention's real heads placed into the zeroed padded
    (kv_pad, g_pad) layout of ``cfg_pad`` (as the JAX package's head
    padding test embeds them): pad rows of wq, wk, wv and wo are 0."""
    H, Hkv, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    Hp, Hkvp = cfg_pad.q_heads_eff, cfg_pad.kv_heads_eff
    g, gp = H // Hkv, Hp // Hkvp
    L = attn["wq"].shape[0]

    def zeros(*shape):
        return attn["wq"].new_zeros(shape)
    wq, wo = zeros(L, D, Hkvp, gp, Dh), zeros(L, Hkvp, gp, Dh, D)
    wk, wv = zeros(L, D, Hkvp, Dh), zeros(L, D, Hkvp, Dh)
    wq[:, :, :Hkv, :g] = attn["wq"].reshape(L, D, Hkv, g, Dh)
    wo[:, :Hkv, :g] = attn["wo"].reshape(L, Hkv, g, Dh, D)
    wk[:, :, :Hkv] = attn["wk"]
    wv[:, :, :Hkv] = attn["wv"]
    return {**attn, "wq": wq.reshape(L, D, Hp, Dh), "wk": wk, "wv": wv,
            "wo": wo.reshape(L, Hp, Dh, D)}


def phase_padded(cfg, pads, B=4, S=2048):
    """The model in a padded head layout (``pads``, with its weights
    embedded by ``pad_heads``) against the unpadded one: the last prefill
    logits of B prompts of S tokens in f32 at full width and depth, with
    the kernels (pad kv heads hold k = v = 0 and pad q heads zero rows of
    wo: their output must vanish, not turn NaN). Identical argmax, max abs
    difference printed (at most 1e-3). → the launch counts."""
    from repro_torch.configs import replace
    from repro_torch.kernels import ops
    from repro_torch.models import Impl, init_params
    from repro_torch.runtime.steps import make_prefill_step

    cfg_pad = replace(cfg, **pads)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7))
    padded = dict(params, blocks=dict(params["blocks"], attn=pad_heads(
        cfg, cfg_pad, params["blocks"]["attn"])))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda")}
    V = cfg.vocab_size
    ops.LAUNCHES.reset()
    want = make_prefill_step(cfg, Impl(), dtype=torch.float32)(params, batch)[:, 0, :V]
    got = make_prefill_step(cfg_pad, Impl(), dtype=torch.float32)(padded, batch)[:, 0, :V]
    launches = ops.LAUNCHES.snapshot()
    check(launches["flash_attention"] == 2 * cfg.num_layers,
          f"{cfg.name} padded: {launches['flash_attention']} flash launches, "
          f"want {2 * cfg.num_layers}")
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()) and torch.equal(got.argmax(-1), want.argmax(-1))
          and err <= 1e-3, f"{cfg.name}: the padded layout's logits differ ({err})")
    emit(phase="padded_heads", arch=cfg.name, dtype="float32", batch=B, prompt_len=S,
         heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
         padded_heads=f"{cfg_pad.q_heads_eff}/{cfg_pad.kv_heads_eff}",
         max_abs_diff=err, argmax_identical=True, launches=launches)
    del params, padded, want, got
    torch.cuda.empty_cache()
    return launches


def _pcts(xs):
    """(p50, p99) of ``xs`` in ms."""
    xs = sorted(xs)
    return xs[len(xs) // 2] * 1e3, xs[min(len(xs) - 1, int(0.99 * len(xs)))] * 1e3


def small_call_ms(session, n=50, n_words=100):
    """p50 and p99 ms of ``n`` lockstep word counts of ``n_words`` words
    through ``session`` (each count checked after its timed round trip)."""
    from repro_torch.core.wordcount import make_text, parse_count
    text = make_text(n_words, seed=3)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        resp = session.request(text)
        ts.append(time.perf_counter() - t0)
        check(parse_count(resp) == n_words, "a small word count came back wrong")
    return _pcts(ts)


def phase_serve(cfg, n_clients=12, sessions=False):
    """The engine behind sealed frames at full width and depth (bf16):
    lockstep clients, one batch envelope of 8 on ``serve_batch``, a
    tampered frame; decode attention must launch once per attention block
    a tick. With ``sessions`` the lockstep clients are sessions of the
    port's ``MPKLinkOptTransport`` in front of ``EngineService.handler``
    (two key syncs a request), and a small word count's round trip through
    a transport of its own is timed with the engine idle and with it
    ticking (outside the counted run); otherwise each client calls
    ``serve_frame``. → (the launch counts of that run, the layer-0 KV
    cache and positions of a dense model or None)."""
    from repro_torch.core import framing, transports
    from repro_torch.core.wordcount import wordcount_handler
    from repro_torch.kernels import ops
    from repro_torch.runtime import EngineService, encode_prompt

    max_new = 32
    path = GUARD_KERNELS + (("decode_attention",) if cfg.family != "ssm" else ())
    torch.cuda.reset_peak_memory_stats()
    eng = _engine(cfg, torch.bfloat16, 0, 8, 1024)
    svc = EngineService(eng, timeout=600).start()
    rng = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(0, cfg.vocab_size, (8 + (40 * i) // 11,),
                             generator=rng).tolist() for i in range(n_clients)]
    results, errors = {}, []
    tr = probe_tr = None
    if sessions:
        tr = transports.MPKLinkOptTransport(svc.handler, device="cuda",
                                            max_keys=4 * n_clients, timeout=600)
        conns = [tr.connect(f"client-{i}") for i in range(n_clients)]
        probe_tr = transports.MPKLinkOptTransport(wordcount_handler, device="cuda")
        probe = probe_tr.connect("probe")

    def client(i):          # one lockstep exchange: seal, serve, verify
        try:
            if sessions:
                resp = conns[i].request(encode_prompt(prompts[i], max_new))
                results[i] = resp.view(torch.int32).cpu().tolist()
                return
            frame = framing.build_frame(encode_prompt(prompts[i], max_new),
                                        seed=SEED, seq=i, device="cuda")
            resp = transports.serve_frame(frame, svc.handler, seed=SEED, seq=i)
            results[i] = framing.verify_view(resp, seed=SEED,
                                             expect_seq=i).cpu().tolist()
        except BaseException as e:
            errors.append(repr(e))

    latency = None
    try:
        # warm-up exchange (library loads, first-call costs), not measured
        if sessions:
            conns[0].request(encode_prompt(prompts[0], 2))
            small_call_ms(probe, n=5)
            idle = small_call_ms(probe)
            syncs0 = tr.sync_count
        else:
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
        if sessions:
            check(tr.sync_count - syncs0 == 2 * n_clients,
                  f"{tr.sync_count - syncs0} key syncs for {n_clients} requests, "
                  f"want 2 a request")

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
        ticks = eng.ticks - ticks0
        if sessions:        # the small call again, with the engine ticking
            stop = threading.Event()

            def load(i):
                try:
                    while not stop.is_set():
                        conns[i].request(encode_prompt(prompts[i], max_new))
                except BaseException as e:
                    errors.append(repr(e))

            loaders = [threading.Thread(target=load, args=(i,)) for i in range(8)]
            for t in loaders:
                t.start()
            busy_by = time.perf_counter() + 300
            while eng.ticks < ticks0 + ticks + 16 and not errors:   # busy
                check(time.perf_counter() < busy_by, "the engine never got busy")
                time.sleep(0.01)
            ticks2, t2 = eng.ticks, time.perf_counter()
            ticking = small_call_ms(probe)
            ticks2, t2 = eng.ticks - ticks2, time.perf_counter() - t2
            stop.set()
            for t in loaders:
                t.join(timeout=600)
                check(not t.is_alive(), "a loading client did not finish")
            check(not errors, f"loading clients failed: {errors}")
            latency = dict(n_words=100, calls=50, idle_p50_ms=idle[0],
                           idle_p99_ms=idle[1], ticking_p50_ms=ticking[0],
                           ticking_p99_ms=ticking[1], ticks_during=ticks2,
                           probe_s=t2, cpu_count=os.cpu_count())
    finally:
        for t in (tr, probe_tr):
            if t is not None:
                t.close()
        svc.close()

    check(refused, "a tampered frame was served")
    toks = [results.get(i) for i in range(n_clients)] + batch
    check(all(t is not None and len(t) == max_new and
              all(0 <= x < cfg.vocab_size for x in t) for t in toks),
          "a response is missing, short or out of the vocabulary")
    check(all(launches[n] > 0 for n in path),
          f"a kernel of the serving path never launched: {launches}")
    n_attn = decode_blocks(cfg)
    check(launches["decode_attention"] == n_attn * ticks,
          f"{cfg.name} serve: {launches['decode_attention']} decode-attention "
          f"launches in {ticks} ticks, want {n_attn} a tick")
    same = sum(results[i] == batch[i] for i in range(8))
    lock_tokens = n_clients * max_new
    emit(phase="serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         ticks=ticks, lockstep_via="mpklink_opt sessions" if sessions else "serve_frame",
         dtype="bfloat16", max_batch=8, max_seq=1024, lockstep_requests=n_clients,
         prompt_tokens=[len(p) for p in prompts], max_new=max_new,
         lockstep_s=lock_s, lockstep_ticks=lock_ticks,
         lockstep_tokens_per_s=lock_tokens / lock_s,
         ms_per_tick=lock_s / lock_ticks * 1e3,
         batch_requests=8, batch_s=batch_s, batch_ticks=batch_ticks,
         batch_tokens_per_s=8 * max_new / batch_s,
         batch_ms_per_tick=batch_s / batch_ticks * 1e3,
         batch_matches_lockstep=same, tampered_frame_refused=refused,
         small_call=latency,
         launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    attn_inputs = None
    if cfg.family in ("dense", "vlm", "moe"):
        caches = eng.state["caches"]
        attn_inputs = (caches["k"][0].clone(), caches["v"][0].clone(),
                       eng.state["pos"].clamp(max=eng.max_seq - 1).clone())
    del eng, svc
    torch.cuda.empty_cache()
    return launches, attn_inputs


# ---------------------------------------------------------------------------
# gateway: the north star's GatewayClient.call("infer", ...) on the card
# ---------------------------------------------------------------------------

def _gw_rows(gw_mod, raw, n):
    """Walk a batch response envelope → [(status, frame or blob, frame
    offset)] (the frame copied to an aligned tensor where it lies off 16
    bytes, as the client does)."""
    hb = gw_mod._HostBytes(raw.reshape(-1).view(torch.uint8))
    route = gw_mod._response_route(hb)
    check(route[1] == 2 and route[3] == n, f"not a batch response: {route}")
    items, ofs = [], 16
    for status, body in gw_mod._read_items(hb, n, "batch"):
        nb = body[0].numel() * 4 if status == 0 else len(body)
        items.append((status, body, ofs + 16))
        ofs += 16 + nb + (-nb) % 4
    return items


def _gw_timed(calls):
    """p50/p99 ms and requests/s of ``calls`` (a list of lists of functions,
    one list a thread, each function one call)."""
    lat, errors, lock = [], [], threading.Lock()

    def run(fns):
        try:
            for fn in fns:
                t0 = time.perf_counter()
                fn()
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)
        except BaseException as e:          # noqa: B036 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(fns,)) for fns in calls]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "a timed gateway caller did not finish")
    wall = time.perf_counter() - t0
    check(not errors, f"timed gateway calls failed: {errors}")
    p50, p99 = _pcts(lat)
    return dict(calls=len(lat), p50_ms=p50, p99_ms=p99,
                requests_per_s=len(lat) / wall)


def phase_gateway(cfg, smi, n_clients=12, max_new=16):
    """The port's ``ServiceGateway("mpklink_opt", workers=2)`` on the card
    with card regions, in front of the engine (``infer``, bf16, full width
    and depth, max_batch 8, max_seq 1024), the word count (``wc``) and an
    allow-listed ``billing`` service, every call through the port's
    ``GatewayClient``s. Held exactly: greedy tokens equal the same engine's
    through ``transports.serve_frame`` with no gateway, on every path
    (lockstep, batch, scatter, coalesced); decode attention once per
    attention block a tick; the guard-kernel launches and key syncs of the
    lockstep, batch and scatter envelopes equal ``launch.gateway_bench``'s
    counts from the code; two scatters under load give identical bits.
    Refused with their typed errors: a frame sealed under wc's channel
    sent to infer, a client with no billing key, a stale key after a
    revocation, a 1 ms budget against the ticking engine, one tampered item
    of a batch (only that item; the next frame lies off 16 bytes). Then a
    fleet of two in-process replicas of wc drained under traffic with no
    lost call, and ``greedy=False`` sampling with seeded CUDA generators.
    Printed, not asserted: requests/s and p50/p99 of calls at 1 and 12
    clients, direct and coalesced, and of a 100-word wc call with infer idle
    and ticking. → the launch counts of the counted runs (lockstep, batch,
    quiet scatter, coalesced)."""
    from repro_torch.core import AccessViolation, ServiceGateway, framing
    from repro_torch.core import gateway as gw_mod
    from repro_torch.core import transports
    from repro_torch.core.transports import DeadlineExpired, _raise_remote
    from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler
    from repro_torch.kernels import ops
    from repro_torch.launch import gateway_bench as gb
    from repro_torch.runtime import EngineService, Request, ServingEngine, encode_prompt

    t_phase = time.perf_counter()
    eng = _engine(cfg, torch.bfloat16, 0, 8, 1024)
    svc = EngineService(eng, timeout=600).start()
    rng = torch.Generator().manual_seed(SEED + 7)
    prompts = [torch.randint(0, cfg.vocab_size, (8 + (40 * i) // 11,),
                             generator=rng).tolist() for i in range(n_clients)]
    reqs = [encode_prompt(p, max_new) for p in prompts]
    n_attn = decode_blocks(cfg)
    errors = []

    def threads_of(fn, n):
        ts = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
            check(not t.is_alive(), "a gateway client thread did not finish")
        check(not errors, f"gateway clients failed: {errors}")

    # the same engine through the service step with no gateway: the oracle
    want = {}

    def oracle(i):
        try:
            frame = framing.build_frame(reqs[i], seed=SEED, seq=i, device="cuda")
            resp = transports.serve_frame(frame, svc.handler, seed=SEED, seq=i)
            want[i] = framing.verify_view(resp, seed=SEED, expect_seq=i).cpu().tolist()
        except BaseException as e:          # noqa: B036 — reported by threads_of
            errors.append(repr(e))

    threads_of(oracle, n_clients)

    gw = ServiceGateway("mpklink_opt", workers=2, max_keys=1024, device="cuda",
                        transport_kwargs={"timeout": 600})
    gw.register_service("infer", svc.handler, batch_handler=svc.handler_batch)
    gw.register_service("wc", wordcount_handler)
    gw.register_service("billing", wordcount_handler, allow={"accountant"})
    gw.start()
    counted, ticks_counted = {}, 0
    checks = {}

    def count_from(launches0_ticks):
        nonlocal ticks_counted
        torch.cuda.synchronize()
        got = ops.LAUNCHES.snapshot()
        ticks = eng.ticks - launches0_ticks
        check(got["decode_attention"] == n_attn * ticks,
              f"gateway: {got['decode_attention']} decode-attention launches in "
              f"{ticks} ticks, want {n_attn} a tick")
        for k, v in got.items():
            counted[k] = counted.get(k, 0) + v
        ticks_counted += ticks
        return got

    def guard(got):
        return {k: v for k, v in got.items() if k in GUARD_KERNELS and v}

    try:
        clients = [gw.connect(f"client-{i}") for i in range(n_clients)]
        for c in clients:
            c.open("infer")
            c.open("wc")
        text = make_text(100, seed=3)
        check(parse_count(clients[0].call("wc", text)) == 100, "wc warm-up")
        clients[0].call("infer", encode_prompt(prompts[0], 2))
        tr = gw.transport
        resp_nb = 4 * max_new

        # 1. lockstep: 12 clients, one call each
        got_lock = {}

        def lock_call(i):
            try:
                got_lock[i] = clients[i].call("infer", reqs[i]).cpu().tolist()
            except BaseException as e:      # noqa: B036
                errors.append(repr(e))

        torch.cuda.synchronize()
        ops.LAUNCHES.reset()
        syncs0, ticks0, t0 = tr.sync_count, eng.ticks, time.perf_counter()
        threads_of(lock_call, n_clients)
        lock_s = time.perf_counter() - t0
        got = count_from(ticks0)
        check(all(got_lock[i] == want[i] for i in range(n_clients)),
              "lockstep gateway tokens differ from serve_frame's")
        want_l = gb._add(*(gb.single_launches(r.nbytes, resp_nb, "cuda") for r in reqs))
        want_s = sum(gb.envelope_syncs(tr, gb.single_bytes(r.nbytes, resp_nb)[0])
                     for r in reqs)
        check(guard(got) == want_l and tr.sync_count - syncs0 == want_s,
              f"lockstep: launches {guard(got)} and {tr.sync_count - syncs0} key "
              f"syncs, the code gives {want_l} and {want_s}")
        checks["lockstep"] = dict(launches=guard(got), key_syncs=want_s,
                                  seconds=lock_s)

        # 2. one batch envelope of 8
        torch.cuda.synchronize()
        ops.LAUNCHES.reset()
        syncs0, ticks0 = tr.sync_count, eng.ticks
        batch = [r.cpu().tolist() for r in clients[0].call_batch("infer", reqs[:8])]
        got = count_from(ticks0)
        check(batch == [want[i] for i in range(8)],
              "batch-envelope tokens differ from serve_frame's")
        want_l = gb.batch_launches([r.nbytes for r in reqs[:8]], [resp_nb] * 8, "cuda")
        want_s = gb.envelope_syncs(tr, gb.batch_bytes([r.nbytes for r in reqs[:8]],
                                                      [resp_nb] * 8)[0])
        check(guard(got) == want_l and tr.sync_count - syncs0 == want_s,
              f"batch: launches {guard(got)} and {tr.sync_count - syncs0} key "
              f"syncs, the code gives {want_l} and {want_s}")
        checks["batch"] = dict(launches=guard(got), key_syncs=want_s)

        # 3. scatter across infer and wc (quiet, counted), then twice under load
        texts = [make_text(50 + 37 * k, seed=k) for k in range(4)]
        items = [("infer", reqs[k]) for k in range(4)] + [("wc", t) for t in texts]
        torch.cuda.synchronize()
        ops.LAUNCHES.reset()
        syncs0, ticks0 = tr.sync_count, eng.ticks
        outs = clients[1].call_many(items)
        got = count_from(ticks0)
        check([o.cpu().tolist() for o in outs[:4]] == [want[k] for k in range(4)]
              and [parse_count(o) for o in outs[4:]] == [50 + 37 * k for k in range(4)],
              "scatter answers differ")
        sizes = [(s, p.nbytes, resp_nb if s == "infer" else 8) for s, p in items]
        want_l = gb.scatter_launches(sizes, "cuda")
        want_s = gb.envelope_syncs(tr, gb.scatter_bytes([n for _, n, _ in sizes],
                                                        [r for _, _, r in sizes])[0])
        check(guard(got) == want_l and tr.sync_count - syncs0 == want_s,
              f"scatter: launches {guard(got)} and {tr.sync_count - syncs0} key "
              f"syncs, the code gives {want_l} and {want_s}")
        checks["scatter"] = dict(launches=guard(got), key_syncs=want_s)

        stop = threading.Event()
        big = make_text(100_000, seed=11)

        def load(i):        # wc traffic on the same transport stream meanwhile
            try:
                while not stop.is_set():
                    check(parse_count(clients[6 + i].call("wc", big)) == 100_000,
                          "a loading wc call came back wrong")
            except BaseException as e:      # noqa: B036
                errors.append(repr(e))

        loaders = [threading.Thread(target=load, args=(i,)) for i in range(4)]
        for t in loaders:
            t.start()
        try:
            runs = [[o.cpu().view(torch.uint8) for o in clients[1].call_many(items)]
                    for _ in range(2)]
        finally:
            stop.set()
            for t in loaders:
                t.join(timeout=600)
        check(not errors, f"loading clients failed: {errors}")
        check(all(torch.equal(a, b) for a, b in zip(*runs))
              and [r.view(torch.int32).tolist() for r in runs[0][:4]]
              == [want[k] for k in range(4)],
              "two scatters under load gave different bits")
        checks["scatter_twice_under_load"] = True

        # 4. refusals, each typed
        c = clients[2]
        chan_wc, chan_inf = c.open("wc"), c.open("infer")
        env = gw_mod._seal_envelope([gw_mod.GW_MAGIC, chan_inf.sid, c.cid, 0],
                                    reqs[0], seed=chan_wc.seed, seq=chan_inf.seq,
                                    device="cuda")
        resp = c._session.request(env).cpu().numpy()
        route = resp[:16].view("<u4")
        try:
            _raise_remote(resp[16:16 + int(route[3])].tobytes())
            refused = None
        except framing.FrameError as e:
            refused = str(e)
        check(int(route[1]) == 1 and refused is not None,
              "a frame sealed under wc's channel was served by infer")
        checks["foreign_channel_frame"] = refused
        try:
            c.call("billing", text)
            check(False, "a client with no billing key was served")
        except AccessViolation as e:
            checks["no_billing_key"] = str(e)
        bad = framing.seal_batch([make_text(n, seed=n) for n in (3, 4, 5)],
                                 seed=chan_wc.seed, start_seq=chan_wc.seq,
                                 device="cuda")
        bad[1].view(torch.int32)[1, 5] ^= 1 << 9
        env = torch.cat([torch.from_numpy(gw_mod._batch_route(chan_wc.sid, c.cid, 3))
                         .cuda()] + [f.reshape(-1).view(torch.uint8) for f in bad])
        rows = _gw_rows(gw_mod, c._session.request(env), 3)
        chan_wc.seq += 3
        check([s for s, _, _ in rows] == [0, 1, 0], f"tampered batch: {rows}")
        check(rows[2][2] % 16 != 0, "the frame after the error blob is aligned")
        ok = framing.verify_batch([rows[0][1][0], rows[2][1][0]], seed=chan_wc.seed,
                                  seqs=[chan_wc.seq - 3, chan_wc.seq - 1])
        check([parse_count(o) for o in ok] == [3, 5], "tampered batch's good items")
        checks["tampered_item"] = dict(statuses=[s for s, _, _ in rows],
                                       next_frame_offset=rows[2][2])
        victim, bystander = clients[3], clients[4]
        stale = bystander.open("wc")
        gw.revoke(victim, "wc")
        try:
            bystander._call_once(stale, text)
            check(False, "a stale key was accepted after a revocation")
        except AccessViolation as e:
            check("stale key epoch" in str(e), f"stale key: {e}")
            checks["stale_key"] = str(e)
        bystander.reopen("wc")
        check(parse_count(bystander.call("wc", text)) == 100, "re-keyed call")

        # 5. printed, not asserted: direct calls at 1 and 12 clients, and a
        # 100-word wc call with infer idle and ticking
        stop.clear()

        def tick_load(i):   # keeps the engine ticking
            try:
                while not stop.is_set():
                    clients[8 + i].call("infer", reqs[8 + i])
            except BaseException as e:      # noqa: B036
                errors.append(repr(e))

        def ticking(fn):
            stop.clear()
            loaders = [threading.Thread(target=tick_load, args=(i,))
                       for i in range(4)]
            for t in loaders:
                t.start()
            try:
                busy_by = time.perf_counter() + 120
                ticks1 = eng.ticks
                while eng.ticks < ticks1 + 4:
                    check(time.perf_counter() < busy_by, "the engine never got busy")
                    time.sleep(0.01)
                return fn()
            finally:
                stop.set()
                for t in loaders:
                    t.join(timeout=600)
                check(not errors, f"ticking clients failed: {errors}")

        short = encode_prompt([1, 2, 3, 4], max_new)

        def infer_at(n):
            return _gw_timed([[lambda c=c: c.call("infer", short)] * (4 if n == 1 else 3)
                              for c in clients[:n]])

        timings = {"direct_infer_1": infer_at(1), "direct_infer_12": infer_at(n_clients),
                   "wc_100_idle": _gw_timed([[lambda: clients[0].call("wc", text)] * 50]),
                   "wc_100_ticking": ticking(lambda: _gw_timed(
                       [[lambda: clients[0].call("wc", text)] * 50]))}

        # 6. coalesced: 12 concurrent callers fold into cohorts
        cohorts0 = len(svc.cohorts)
        gw.enable_coalescing(max_batch=n_clients, max_wait_us=20000.0)
        got_co = {}

        def co_call(i):
            try:
                got_co[i] = clients[i].call("infer", reqs[i]).cpu().tolist()
            except BaseException as e:      # noqa: B036
                errors.append(repr(e))

        torch.cuda.synchronize()
        ops.LAUNCHES.reset()
        ticks0 = eng.ticks
        threads_of(co_call, n_clients)
        count_from(ticks0)
        cohorts = svc.cohorts[cohorts0:]
        check(all(got_co[i] == want[i] for i in range(n_clients)),
              "coalesced tokens differ from serve_frame's")
        check(cohorts and max(cohorts) > 1, f"no cohort reached the engine: {cohorts}")
        checks["coalesced_cohorts"] = cohorts
        timings["coalesced_infer_1"] = infer_at(1)
        timings["coalesced_infer_12"] = infer_at(n_clients)

        def one_ms():
            try:
                clients[5].call("infer", reqs[5], timeout=0.001)
                check(False, "a 1 ms budget was served")
            except DeadlineExpired as e:
                return str(e)

        checks["one_ms_budget"] = ticking(one_ms)

        # 7. a fleet of two in-process mpklink_opt replicas of wc
        for _ in range(2):
            gw.register_replica("wcf", wordcount_handler, transport="mpklink_opt")
        fleet = gw.fleet("wcf")
        served, drained = [0], {}
        stop.clear()

        def fleet_call(i):
            try:
                k = 0
                while not stop.is_set() or k < 8:
                    n = 20 + i * 7 + k
                    check(parse_count(clients[i].call("wcf", make_text(n, seed=k)))
                          == n, "a fleet answer came back wrong")
                    served[0] += 1
                    k += 1
            except BaseException as e:      # noqa: B036
                errors.append(repr(e))

        fl = [threading.Thread(target=fleet_call, args=(i,)) for i in range(4)]
        for t in fl:
            t.start()
        try:
            time.sleep(0.5)
            drained["ok"] = gw.drain_replica("wcf", 0, timeout=60)
            time.sleep(0.5)
        finally:
            stop.set()
            for t in fl:
                t.join(timeout=600)
        check(not errors, f"fleet calls were lost: {errors}")
        snap = gw.fleet_stats()["wcf"]
        check(drained["ok"] and snap[0]["state"] == "quiesced"
              and snap[0]["inflight"] == 0, f"drain: {snap}")
        checks["fleet"] = dict(calls=served[0], lost=0,
                               routed=dict(fleet.router.assigned), replicas=snap)
    finally:
        gw.close()
        svc.close()

    # 8. non-greedy sampling with seeded CUDA generators
    def sampled(seed):
        e = ServingEngine(cfg, eng.params, max_batch=4, max_seq=128,
                          dtype=torch.bfloat16, device="cuda", greedy=False,
                          seed=seed)
        for i, p in enumerate(prompts[:4]):
            e.submit(Request(rid=i, prompt=p, max_new=8))
        out = {r.rid: r.generated for r in e.run_until_drained()}
        check(e.generator.device.type == "cuda", "the generator is not on the card")
        return out

    s1, s1b, s2 = sampled(1), sampled(1), sampled(2)
    check(all(0 <= t < cfg.vocab_size for g in s1.values() for t in g)
          and all(len(g) == 8 for g in s1.values()), "sampled tokens out of range")
    check(s1 == s1b, "the same seed gave other tokens")
    check(s1 != s2, "another seed gave the same tokens")
    checks["sampling"] = dict(seed1=[s1[i] for i in range(4)],
                              seed2=[s2[i] for i in range(4)])
    emit(phase="gateway", arch=cfg.name, layers=cfg.num_layers, dtype="bfloat16",
         max_batch=8, max_seq=1024, clients=n_clients, max_new=max_new,
         workers=2, transport="mpklink_opt", card=smi, cpu_count=os.cpu_count(),
         ticks_counted=ticks_counted, launches=counted, checks=checks,
         timings=timings, wall_s=time.perf_counter() - t_phase)
    del eng, svc
    torch.cuda.empty_cache()
    return counted


# ---------------------------------------------------------------------------
# copyplane: the legacy copy plane beside the in-place one
# ---------------------------------------------------------------------------

COPYPLANE_SIZES = (64 << 10, 1 << 20)
COPYPLANE_REPS = 20


def _copyplane_frames(gen):
    """Frames of the two planes on the card, bit for bit: ``build_frame``
    at 64 KiB, 1 MiB and a padded size, two sequence numbers, against each
    other and against the in-place frame sealed on the CPU; a legacy batch
    (``seal_batch_legacy``) against ``seal_batch``."""
    from repro_torch.core import framing
    sizes = COPYPLANE_SIZES + ((64 << 10) + 3,)
    for nbytes in sizes:
        p = torch.randint(0, 256, (nbytes,), generator=gen, device="cuda",
                          dtype=torch.uint8)
        for seq in (0, 77):
            framing.ZERO_COPY = True
            zc = framing.build_frame(p, seed=SEED, seq=seq, device="cuda")
            host = framing.build_frame(p.cpu(), seed=SEED, seq=seq, device="cpu")
            framing.ZERO_COPY = False
            try:
                legacy = framing.build_frame(p, seed=SEED, seq=seq, device="cuda")
            finally:
                framing.ZERO_COPY = True
            check(_same(legacy, zc) and torch.equal(legacy.cpu().view(torch.int32),
                                                    host.view(torch.int32)),
                  f"copyplane: {nbytes}-byte frames differ between the planes")
        framing.ZERO_COPY = False
        try:
            lb = framing.seal_batch_legacy([p] * 4, seed=SEED, seqs=[1, 2, 3, 4],
                                           device="cuda")
        finally:
            framing.ZERO_COPY = True
        zb = framing.seal_batch([p] * 4, seed=SEED, seqs=[1, 2, 3, 4], device="cuda")
        check(all(_same(a, b) for a, b in zip(lb, zb)),
              f"copyplane: {nbytes}-byte batch frames differ between the planes")
    return len(sizes)


def _copyplane_interleaved():
    """One mpklink_opt session on the card taking legacy and in-place
    requests in turn (the reference's
    ``test_legacy_mode_interoperates_on_the_wire``): every count right and
    the session's sequence at the number of requests."""
    from repro_torch.core import framing
    from repro_torch.core.transports import MPKLinkOptTransport
    from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler
    tr = MPKLinkOptTransport(wordcount_handler, device="cuda")
    s = tr.connect("mixed")
    modes = (False, True, False, True, True, False)
    try:
        for i, zc in enumerate(modes):
            framing.ZERO_COPY = zc
            n = 5 + 997 * i
            got = parse_count(s.request(make_text(n, seed=i)))
            check(got == n, f"copyplane: interleaved request {i}: {got} != {n}")
    finally:
        framing.ZERO_COPY = True
        tr.close()
    check(s._seq == len(modes), f"copyplane: the session's seq is {s._seq}")
    return len(modes)


def phase_copyplane(smi, reps=COPYPLANE_REPS):
    """The legacy copy plane (``framing.ZERO_COPY = False``: pad and header
    concatenations, copies into the region or envelope, the two-launch MAC
    kernels) beside the in-place one, on ``cuda:0``. Held: frames of the two
    planes bit-identical on the card (and to the CPU's); one session that
    interleaves the planes keeps its sequence; then ``mpklink_opt`` through
    the gateway with the ``digest`` service at 64 KiB and 1 MiB, k = 1 and
    4 in flight (``launch.gateway_bench.run_payload_cell``, a fresh gateway
    a plane, as the reference's sweep runs it): digests right in both
    planes, ``concat_calls`` 0 a request in place and at least 1 in the
    legacy plane, and each cell's guard launches exactly
    ``gateway_bench.single_launches`` / ``batch_launches`` a call (the
    two-launch kernels only in the legacy plane). Printed, not asserted:
    requests/s, MiB/s, p50/p99, bytes copied a request and
    ``zero_copy_speedup``. → the launches of the cells."""
    import numpy as np
    from repro_torch.core import ServiceGateway, framing
    from repro_torch.kernels import ops
    from repro_torch.launch import gateway_bench as gb
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    checks = {"frame_sizes_bit_identical": _copyplane_frames(gen),
              "interleaved_requests": _copyplane_interleaved()}
    cells, launches = [], {}
    for zero_copy in (False, True):
        gw = ServiceGateway("mpklink_opt", max_keys=256, device="cuda")
        gw.register_service("digest", gb.digest_handler)
        gw.start()
        try:
            probe = gw.connect(f"copyplane-probe-{zero_copy}")
            p = np.random.default_rng(5).integers(0, 256, 70_001).astype(np.uint8)
            framing.ZERO_COPY = zero_copy
            try:
                got = [int(probe.call("digest", p)[0])] + [
                    int(r[0]) for r in probe.call_batch("digest", [p, p[:9]])]
            finally:
                framing.ZERO_COPY = True
            want = [int(p.sum(dtype=np.int64)), int(p.sum(dtype=np.int64)),
                    int(p[:9].sum(dtype=np.int64))]
            check(got == want, f"copyplane: digests {got} != {want} "
                               f"(zero_copy={zero_copy})")
            for nbytes in COPYPLANE_SIZES:
                for k in (1, gb.PAYLOAD_IN_FLIGHT):
                    ops.LAUNCHES.reset()
                    cell = gb.run_payload_cell(gw, nbytes, reps, zero_copy, k)
                    n = {name: v for name, v in ops.LAUNCHES.snapshot().items() if v}
                    per = (gb.single_launches(nbytes, 8, "cuda", zero_copy) if k == 1
                           else gb.batch_launches([nbytes] * k, [8] * k, "cuda",
                                                  zero_copy))
                    want = {name: v * (reps + 3) for name, v in per.items()}
                    check(n == want, f"copyplane {cell['mode']} {nbytes} k={k}: "
                                     f"launches {n} != {want}")
                    concat = cell["concat_calls_per_request"]
                    check(concat == 0 if zero_copy else concat >= 1,
                          f"copyplane {cell['mode']} {nbytes} k={k}: "
                          f"{concat} concatenations a request")
                    cell.update(transport="mpklink_opt", launches=n)
                    cells.append(cell)
                    for name, v in n.items():
                        launches[name] = launches.get(name, 0) + v
        finally:
            gw.close()
    speedup = gb.payload_speedup(cells)
    emit(phase="copyplane", card=smi, transport="mpklink_opt", reps=reps,
         cells=cells, zero_copy_speedup=speedup,
         zero_copy_gate_mpklink_opt_1p5x=gb.zero_copy_gate(speedup),
         checks=checks, launches=launches, wall_s=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# examples: the seven example modules on the card
# ---------------------------------------------------------------------------

EXAMPLES_IN_PROCESS = ("mpklink_demo", "gateway_demo", "chaos_demo", "quickstart",
                       "serve_decode", "train_e2e")
EXAMPLE_LAUNCHES = {"mpklink_demo": ("guard_copy", "mac_batch", "mac_update"),
                    "gateway_demo": ("guard_copy", "mac_update"),
                    "chaos_demo": ("guard_copy", "mac_update"),
                    "quickstart": ("flash_attention", "flash_attention_bwd",
                                   "decode_attention", "guard_copy"),
                    "serve_decode": ("ssd_scan",),
                    "train_e2e": ("flash_attention", "flash_attention_bwd"),
                    "fabric_parallel_demo": ("flash_attention", "mac_batch")}
EXAMPLES_LOG_DIR = os.path.join("build", "examples")


def phase_examples(smi, timeout=300):
    """``repro_torch.examples``, each at its default size on the card
    (``--device cuda``, the default): the six that start no process run
    here, each's ``main`` with the launch counts zeroed before it and read
    after it; the fabric demo (four ranks from a forkserver, which
    re-import the main module) runs as ``python -m
    repro_torch.examples.fabric_parallel_demo`` and reports its ranks'
    launches. Each example raises on a failed check; each must end with
    its ``... OK`` line and launch the kernels of its path. The output of
    each is kept in ``build/examples/<name>.log``. → the launches."""
    import ast
    import contextlib
    import importlib
    import io
    os.makedirs(EXAMPLES_LOG_DIR, exist_ok=True)
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    recs, launches = {}, {}
    for name in EXAMPLES_IN_PROCESS:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf = io.StringIO()
        ops.LAUNCHES.reset()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main([])
        finally:
            with open(os.path.join(EXAMPLES_LOG_DIR, f"{name}.log"), "w") as f:
                f.write(buf.getvalue())
        n = {k: v for k, v in ops.LAUNCHES.snapshot().items() if v}
        recs[name] = dict(wall_s=time.perf_counter() - t0, launches=n,
                          last=buf.getvalue().strip().splitlines()[-1])
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([os.environ["PYTHONPATH"]]
                                      if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.examples.fabric_parallel_demo"],
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    with open(os.path.join(EXAMPLES_LOG_DIR, "fabric_parallel_demo.log"), "w") as f:
        f.write(r.stdout + r.stderr)
    check(r.returncode == 0, f"examples: fabric_parallel_demo exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    line = next(x for x in r.stdout.splitlines() if x.startswith("kernel launches"))
    n = {k: v for k, v in ast.literal_eval(line.split(":", 1)[1].strip()).items() if v}
    recs["fabric_parallel_demo"] = dict(wall_s=time.perf_counter() - t0, launches=n,
                                        last=r.stdout.strip().splitlines()[-1])
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v
    for name, rec in recs.items():
        check(rec["last"] == f"{name} OK", f"examples: {name} ended {rec['last']!r}")
        missing = [k for k in EXAMPLE_LAUNCHES[name] if not rec["launches"].get(k)]
        check(not missing, f"examples: {name} never launched {missing}")
    emit(phase="examples", card=smi, examples=recs, launches=launches,
         wall_s=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# ipc: the paper's word count over the six transports
# ---------------------------------------------------------------------------

PROC_WORDS = (100, 10_000, 1_000_000)
PROC_NAMES = ("mpklink_opt_proc", "mpklink_proc", "shm_proc", "rest", "sockrpc")


def _child_delta(before, after):
    """Launch counts a child published between two readings (its words
    wrap at 2**32)."""
    return {k: (after[k] - before[k]) & 0xFFFFFFFF for k in after
            if (after[k] - before[k]) & 0xFFFFFFFF}


def _in_threads(fn, args, timeout=600):
    """``fn(a)`` for every ``a`` of ``args``, each on a thread of its own
    (service children start side by side: each pays for a CUDA context);
    raises with the first failures."""
    errors = []

    def run(a):
        try:
            fn(a)
        except BaseException as e:              # noqa: B036 — reported below
            errors.append(repr(e))

    ts = [threading.Thread(target=run, args=(a,)) for a in args]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    check(not errors and all(not t.is_alive() for t in ts),
          f"threads failed: {errors[:3]}")


def _proc_transport(name, handler, timeout=120.0):
    """One of the five process transports on the card; the mpklink pair
    gets room for a 1e6-word request (8 MiB a direction, a ring of 2) and
    keys for more than 16 sessions."""
    from repro_torch.core import ALL_TRANSPORTS
    kw = {"capacity": 8 << 20, "ring_slots": 2, "max_keys": 64} \
        if "mpklink" in name else {}
    return ALL_TRANSPORTS[name](handler, timeout=timeout, **kw)


def proc_wordcount(smi, launches):
    """The paper's word count over the five process transports at 1e2, 1e4
    and 1e6 words, 3 reps each, each request's bits compared across the
    reps: exact counts; shm_proc refuses 1e6 words (CapacityError) as the
    reference does; key syncs and guard launches a request, in the parent
    and in the service child, equal the code's counts; a response sealed
    in the child equals, word for word, the plain version's seal of the
    same bytes, seed and sequence on the CPU."""
    from repro_torch.core import framing, procwire
    from repro_torch.core.transports import CapacityError
    from repro_torch.core.wordcount import parse_count, wordcount_handler
    from repro_torch.kernels import ops
    from repro_torch.launch import ipc_wordcount as ipc

    rows, t_phase = [], time.perf_counter()
    trs = {name: _proc_transport(name, wordcount_handler) for name in PROC_NAMES}
    try:
        sessions = {name: tr.connect() for name, tr in trs.items()}
        # children start, workspaces: untimed, side by side
        _in_threads(lambda s: s.request(ipc.text_of(1)), sessions.values())
    except BaseException:
        for tr in trs.values():
            tr.close()
        raise
    for name in PROC_NAMES:
        tr, s = trs[name], sessions[name]
        try:
            mpk = name in ipc.MPK_PROC
            for n in PROC_WORDS:
                text = ipc.text_of(n)
                if name == "shm_proc" and text.nbytes > tr.capacity:
                    try:
                        s.request(text)
                    except CapacityError:
                        rows.append(dict(transport=name, words=n, refused=True))
                        continue
                    check(False, f"shm_proc served {n} words past its capacity")
                want_p, want_c = ipc.proc_launches(name, text.nbytes, tr.device)
                ts, bits = [], set()
                for _ in range(3):
                    syncs0 = getattr(s, "sync_count", 0)
                    child0 = s.child_launches() if mpk or name == "shm_proc" else None
                    torch.cuda.synchronize()
                    ops.LAUNCHES.reset()
                    t_seq = getattr(s, "_seq", None)
                    t0 = time.perf_counter()
                    resp = s.request(text)
                    ts.append(time.perf_counter() - t0)
                    got_p = {k: v for k, v in ops.LAUNCHES.snapshot().items() if v}
                    check(parse_count(resp) == n, f"{name}: {n} words counted wrong")
                    bits.add(resp.cpu().numpy().tobytes())
                    syncs = getattr(s, "sync_count", 0) - syncs0
                    check(syncs == ipc.lockstep_syncs(tr, text.nbytes),
                          f"{name} at {n} words: {syncs} key syncs, the code gives "
                          f"{ipc.lockstep_syncs(tr, text.nbytes)}")
                    got_c = _child_delta(child0, s.child_launches()) \
                        if child0 is not None else {}
                    check(got_p == want_p and got_c == want_c,
                          f"{name} at {n} words: launches {got_p} / child {got_c}, "
                          f"the code gives {want_p} / {want_c}")
                    for k, v in list(got_p.items()) + list(got_c.items()):
                        launches[k] = launches.get(k, 0) + v
                    if mpk:
                        # the child's response frame, against the plain seal
                        b = procwire.PROC_CTRL_WORDS + (s._tickets - 1) % s._nslots \
                            * procwire.PROC_SLOT_WORDS
                        w = s._w
                        off, r = w[b + procwire._S_RESP_OFF], w[b + procwire._S_RESP_ROWS]
                        frame = s._slab[off:off + r].cpu()
                        plain = framing.build_frame(resp.cpu(), seed=s.seed,
                                                    seq=t_seq, device="cpu")
                        check(torch.equal(frame.view(torch.int32),
                                          plain.view(torch.int32)),
                              f"{name}: a response sealed in the child differs "
                              f"from the plain seal on the CPU")
                check(len(bits) == 1, f"{name} at {n} words: reps differ")
                p50 = sorted(ts)[1] * 1e3
                rows.append(dict(transport=name, words=n, ms_p50=p50,
                                 key_syncs=ipc.lockstep_syncs(tr, text.nbytes),
                                 parent_launches=want_p, child_launches=want_c))
            s.close()
        finally:
            tr.close()
    emit(phase="proc_wordcount", card=smi, cpu_count=os.cpu_count(), rows=rows,
         wall_s=time.perf_counter() - t_phase)


def proc_comparison(smi, n_clients=16, per_client=20, n_words=10_000):
    """The paper's headline comparison across a process boundary: 16
    clients in a closed loop, one session each, on 1e4-word requests, for
    mpklink_opt_proc, rest and sockrpc. Printed, not asserted (the
    reference's 2x gate is reported as a ratio)."""
    from repro_torch.core.wordcount import parse_count, wordcount_handler
    from repro_torch.launch import ipc_wordcount as ipc

    text = ipc.text_of(n_words)
    out, t_phase = {}, time.perf_counter()

    def warm(s):
        check(parse_count(s.request(text)) == n_words, f"{s.name} warm-up")

    for name in ("mpklink_opt_proc", "rest", "sockrpc"):
        tr = _proc_transport(name, wordcount_handler)
        lat, errors = [], []
        try:
            sessions = [tr.connect(f"c{i}") for i in range(n_clients)]
            _in_threads(warm, sessions)         # child starts: untimed
            barrier = threading.Barrier(n_clients + 1)

            def client(s):
                try:
                    barrier.wait()
                    for _ in range(per_client):
                        t0 = time.perf_counter()
                        resp = s.request(text)
                        lat.append(time.perf_counter() - t0)
                        check(parse_count(resp) == n_words, "a count came back wrong")
                except BaseException as e:      # noqa: B036 — reported below
                    errors.append(repr(e))

            ts = [threading.Thread(target=client, args=(s,)) for s in sessions]
            for t in ts:
                t.start()
            barrier.wait()
            t0 = time.perf_counter()
            for t in ts:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            check(not errors and all(not t.is_alive() for t in ts),
                  f"{name}: clients failed {errors[:3]}")
            p50, p99 = _pcts(lat)
            out[name] = dict(rps=n_clients * per_client / wall, p50_ms=p50,
                             p99_ms=p99)
            for s in sessions:
                s.close()
        finally:
            tr.close()
    ratio = out["mpklink_opt_proc"]["rps"] / out["rest"]["rps"]
    emit(phase="proc_comparison", card=smi, cpu_count=os.cpu_count(),
         clients=n_clients, words=n_words, results=out,
         mpklink_opt_proc_over_rest=ratio, wall_s=time.perf_counter() - t_phase)
    print(f"# proc comparison: mpklink_opt_proc/rest requests/s = {ratio:.3f} "
          f"(the reference's gate asks >= 2; cpu_count {os.cpu_count()}; {smi})",
          flush=True)


def _tokens(t):
    """Generated tokens from a response: int32 words, whether it comes back
    typed or as its bytes (a replica process answers with bytes)."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8) \
        .view(torch.int32).tolist()


def proc_replicas(cfg, smi, launches, n_clients=12, max_new=16):
    """llama3.2-1b at full width and depth (bf16, max_batch 8, max_seq
    1024) in two replica processes behind the port's gateway on the card:
    greedy tokens of 12 clients equal the same seeded engine's through
    ``transports.serve_frame`` in the parent; each child launches decode
    attention once per attention block a tick. Then ``kill -9`` one
    replica's child under 4 client threads: every call completes correctly
    or raises a typed error, ``FleetSupervisor(target=2)`` brings the
    replica back, and tokens after the restart still match. Then
    everything closes: no ``mpkt_`` segment and no child is left."""
    import functools
    import multiprocessing
    import signal

    from repro_torch.core import ServiceGateway, framing, procwire, transports
    from repro_torch.core.gateway import REPLICA_ACTIVE, FleetSupervisor
    from repro_torch.core.transports import TransportError
    from repro_torch.kernels import ops
    from repro_torch.runtime import (EngineService, encode_prompt,
                                     register_engine_fleet, seeded_engine)
    from repro_torch.runtime.serve import FLEET_STATS

    factory = functools.partial(seeded_engine, cfg.name, SEED, max_batch=8,
                                max_seq=1024, dtype="bfloat16")
    rng = torch.Generator().manual_seed(SEED + 9)
    prompts = [torch.randint(0, cfg.vocab_size, (8 + (40 * i) // 11,),
                             generator=rng).tolist() for i in range(n_clients)]
    reqs = [encode_prompt(p, max_new) for p in prompts]
    short = [encode_prompt(p[:8], 4) for p in prompts[:4]]
    n_attn = decode_blocks(cfg)

    # the oracle: the same seeded engine in this process, through the
    # service step with no gateway
    t_phase = time.perf_counter()
    svc = EngineService(factory(), timeout=600).start()
    try:
        oracle = {}

        def serve(i):
            frame = framing.build_frame((reqs + short)[i], seed=SEED, seq=i,
                                        device="cuda")
            resp = transports.serve_frame(frame, svc.handler, seed=SEED, seq=i)
            oracle[i] = _tokens(framing.verify_view(resp, seed=SEED,
                                                    expect_seq=i))

        _in_threads(serve, range(len(reqs) + len(short)))
        want = [oracle[i] for i in range(n_clients)]
        want_short = [oracle[n_clients + i] for i in range(len(short))]
    finally:
        svc.close()
        del svc
        torch.cuda.empty_cache()

    def stats(rep):
        with rep.rlock:
            doc = rep.session.request(FLEET_STATS)
        return json.loads(doc.cpu().numpy().tobytes())

    gw = ServiceGateway("mpklink_opt", max_keys=1024,
                        transport_kwargs={"timeout": 600})
    sup = None
    try:
        register_engine_fleet(gw, "infer", factory, replicas=2,
                              transport_kwargs={"timeout": 600})
        gw.start()
        fleet = gw.fleet("infer")
        t0 = time.perf_counter()

        def warm(rep):                          # child, CUDA context, engine
            with rep.rlock:
                rep.session.request(encode_prompt(prompts[0][:2], 1))

        _in_threads(warm, list(fleet._replicas.values()))
        warm_s = time.perf_counter() - t0
        before = {rid: stats(rep) for rid, rep in fleet._replicas.items()}
        clients = [gw.connect(f"client-{i}") for i in range(n_clients)]
        got, errors = {}, []

        def call(i):
            try:
                got[i] = _tokens(clients[i].call("infer", reqs[i]))
            except BaseException as e:          # noqa: B036 — reported below
                errors.append(repr(e))

        torch.cuda.synchronize()
        ops.LAUNCHES.reset()
        t0 = time.perf_counter()
        ts = [threading.Thread(target=call, args=(i,)) for i in range(n_clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        serve_s = time.perf_counter() - t0
        check(not errors, f"replica clients failed: {errors[:3]}")
        check([got[i] for i in range(n_clients)] == want,
              "tokens through two replica processes differ from serve_frame's")
        torch.cuda.synchronize()
        parent = {k: v for k, v in ops.LAUNCHES.snapshot().items() if v}
        for k, v in parent.items():
            launches[k] = launches.get(k, 0) + v
        per_child = {}
        for rid, rep in fleet._replicas.items():
            after = stats(rep)
            ticks = after["ticks"] - before[rid]["ticks"]
            d = _child_delta(before[rid]["launches"], after["launches"])
            on_card = gw.device.type == "cuda"
            check(d.get("decode_attention", 0) == n_attn * ticks * on_card,
                  f"replica {rid}: {d.get('decode_attention', 0)} decode-attention "
                  f"launches in {ticks} ticks, want {n_attn} a tick")
            per_child[rid] = dict(ticks=ticks, launches=d,
                                  card_bytes=after["card_bytes"])
            for k, v in d.items():
                launches[k] = launches.get(k, 0) + v
        check(sum(c["ticks"] for c in per_child.values()) > 0
              and all(c["ticks"] for c in per_child.values()),
              f"a replica served nothing: {per_child}")
        emit(phase="proc_replicas", card=smi, cpu_count=os.cpu_count(),
             replicas=2, clients=n_clients, warm_s=warm_s, serve_s=serve_s,
             parent_launches=parent, children=per_child)

        # recovery under traffic
        sup = FleetSupervisor(gw, "infer", target=2, interval=0.2,
                              probe_timeout=300.0).start()
        outcomes, stop = [], threading.Event()
        lock = threading.Lock()

        def traffic(i):
            cli = gw.connect(f"traffic-{i}", retries=3)
            try:
                while not stop.is_set():
                    try:
                        out = _tokens(cli.call("infer", short[i]))
                        rec = ("ok", out)
                    except TransportError as e:   # typed: allowed
                        rec = ("typed", type(e).__name__)
                    except BaseException as e:     # noqa: B036 — must not happen
                        rec = ("untyped", repr(e))
                    with lock:
                        outcomes.append((i, rec))
            finally:
                cli.close()

        ts = [threading.Thread(target=traffic, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 120
        while len(outcomes) < 8 and time.monotonic() < deadline:
            time.sleep(0.05)
        victim = fleet._replicas[1]
        os.kill(victim.session._proc.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        healed_s = None
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            active = [r for r in fleet.snapshot() if r["state"] == "active"]
            if sup.stats["respawns"] >= 1 and len(active) == 2:
                healed_s = time.perf_counter() - t_kill
                break
            time.sleep(0.1)
        time.sleep(1.0)                         # traffic over the healed set
        stop.set()
        for t in ts:
            t.join(timeout=600)
        sup.stop()
        check(healed_s is not None,
              f"the supervisor did not bring the replica back: {sup.stats} "
              f"{fleet.snapshot()}")
        bad = [o for o in outcomes if o[1][0] == "untyped"]
        check(not bad, f"untyped failures under kill -9: {bad[:3]}")
        oks = [(i, rec[1]) for i, rec in outcomes if rec[0] == "ok"]
        check(all(out == want_short[i] for i, out in oks),
              "tokens under kill -9 differ from serve_frame's")
        # after the restart: through the gateway, and every live replica
        cli = gw.connect("after-restart")
        check([_tokens(cli.call("infer", r)) for r in short] == want_short,
              "tokens after the restart differ from serve_frame's")
        cli.close()
        live = [(rid, rep) for rid, rep in fleet._replicas.items()
                if rep.state == REPLICA_ACTIVE]
        check(len(live) == 2, f"{len(live)} active replicas after the restart")
        for rid, rep in live:
            with rep.rlock:
                alone = _tokens(rep.session.request(short[0]))
            check(alone == want_short[0], f"replica {rid} after the restart differs")
        typed = sum(1 for o in outcomes if o[1][0] == "typed")
        emit(phase="proc_recovery", card=smi, cpu_count=os.cpu_count(),
             calls=len(outcomes), ok=len(oks), typed=typed,
             healed_s=healed_s, supervisor=dict(sup.stats),
             wall_s=time.perf_counter() - t_phase)
    finally:
        if sup is not None:
            sup.stop()
        gw.close()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        kids = multiprocessing.active_children()
        segs = [f for f in os.listdir("/dev/shm")
                if f.startswith(f"{procwire.SEGMENT_PREFIX}{os.getpid()}_")]
        if not kids and not segs:
            break
        time.sleep(0.1)
    check(not kids and not segs,
          f"after close: children {[k.pid for k in kids]}, segments {segs}")


def proc_gateway_child(smi, n_requests=32):
    """``ServiceGateway("mpklink_opt_proc")``: the gateway itself runs in a
    service process on the card, with the word count; a FaultPlan of all
    eight kinds (32 requests at rate 0.25: each kind once) through
    FaultyClient: every fault typed as EXPECTED (a crash kills the child,
    the heal starts a fresh one), every wait bounded."""
    from repro_torch.core import ServiceGateway
    from repro_torch.core.faultwire import (EXPECTED, FaultFabric, FaultPlan,
                                            FaultyClient)
    from repro_torch.core.wordcount import make_text, parse_count, wordcount_handler

    plan = FaultPlan(seed=2024, n_requests=n_requests, rate=0.25)
    gw = ServiceGateway("mpklink_opt_proc", transport_kwargs={"timeout": 1.0})
    gw.register_service("wordcount", wordcount_handler)
    gw.start()
    fab = FaultFabric(plan).attach(gw)
    fc = FaultyClient(gw.connect("chaos"), fab, "wordcount")
    t0 = time.perf_counter()
    try:
        for i in range(n_requests):
            n = 4 + i % 9
            out = fc.step(make_text(n, seed=i))
            if out.status == "ok":
                check(parse_count(out.value) == n, f"wrong count at {i}")
    finally:
        wall = time.perf_counter() - t0
        gw.close()
    counts = fc.counts()
    check(counts["error"] == 0, f"untyped or collateral failures: {counts} — "
          f"{plan.describe()}")
    check({e.kind for e in plan.events.values()} == set(EXPECTED),
          "the plan does not hold every fault kind")
    check(all(isinstance(o.value, EXPECTED[o.kind]) for o in fc.outcomes
              if o.status == "fault"), "a fault surfaced with the wrong type")
    check(wall < 120, f"fault run took {wall:.1f} s")
    emit(phase="proc_gateway_child", card=smi, requests=n_requests,
         faults=len(plan.events), outcomes=counts, wall_s=wall)


def phase_proc(cfg, smi):
    """Every service in a process of its own (``core.procwire``), on the
    card: the word count over the five process transports, the paper's
    16-client comparison (printed), two llama3.2-1b replica processes with
    their tokens, launches and recovery after ``kill -9``, and a gateway
    that runs in its child under all eight fault kinds. → the kernel
    launches of the checked runs, the parent's and the children's."""
    t0 = time.perf_counter()
    launches = {}
    proc_wordcount(smi, launches)
    proc_comparison(smi)
    proc_replicas(cfg, smi, launches)
    proc_gateway_child(smi)
    emit(phase="proc_done", card=smi, cpu_count=os.cpu_count(),
         wall_s=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# fabric: four ranks on the one card, over gloo, staged through the host
# ---------------------------------------------------------------------------

FABRIC_WORLD = 4
FABRIC_MiB = 64                      # per rank, each guarded collective
FABRIC_KERNELS = ("mac_batch", "flash_attention", "flash_attention_bwd")


def _close(got, want, tol):
    """Max abs error of ``got`` against ``want`` (f32), checked against
    ``tol`` times max(1, max |want|) → the error."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    return err, err <= tol * scale


def _gloo_takes_cuda(rank, world):
    """Which gloo collectives accept CUDA tensors here: each is tried on a
    small tensor in every rank (a refusal is raised in every rank alike),
    then the ranks meet at a barrier. Point-to-point is not tried: gloo's
    ``isend`` of a CUDA tensor writes the device pointer to its socket and
    aborts the process (``writev ... Bad address``, torch 2.11)."""
    import torch.distributed as dist
    t = torch.ones(4, device="cuda")
    probes = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(world)], t),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
    }
    out = {}
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = True
        except RuntimeError:             # gloo refuses the device
            out[name] = False
        dist.barrier()
    return out


class _Case:
    """Wall ms (the ranks meet first, the card is synchronised after),
    staged bytes and kernel launches of one case in this rank."""

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        import torch.distributed as dist
        from repro_torch.core.fabric import FABRIC_STATS
        from repro_torch.kernels.ops import LAUNCHES
        torch.cuda.synchronize()
        dist.barrier()
        FABRIC_STATS.reset()
        LAUNCHES.reset()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from repro_torch.core.fabric import FABRIC_STATS
        from repro_torch.kernels.ops import LAUNCHES
        torch.cuda.synchronize()
        self.rec["wall_ms"] = (time.perf_counter() - self.t0) * 1e3
        self.rec.update(FABRIC_STATS.snapshot())
        n = LAUNCHES.snapshot()
        self.rec["launches"] = {k: n[k] for k in FABRIC_KERNELS}
        return False


def _fabric_collectives(rank, world, fab, chan, key, raw, raw_key):
    from repro_torch.core.fabric import (all_to_all, attach_mac, neighbor_exchange,
                                         reduce_scatter_ring, ring_all_gather,
                                         verify_mac)
    n = FABRIC_MiB * 2 ** 20 // 4

    def data(r):
        g = torch.Generator(device="cuda").manual_seed(SEED + 100 + r)
        return torch.randn(n, generator=g, device="cuda")

    x = data(rank)
    everyone = torch.stack([data(r) for r in range(world)])
    rec = {"mib_a_rank": FABRIC_MiB}
    with _Case(rec):
        y, ok_ne = neighbor_exchange(fab, chan, key, x)
        gathered, ok_ag = ring_all_gather(fab, chan, key, x)
        shard, ok_rs = reduce_scatter_ring(fab, chan, key, x)
        a2a = all_to_all(fab, chan, key, x.view(world, -1), split_axis=0,
                         concat_axis=0)
    oks = [int(o.item()) for o in (ok_ne, ok_ag, ok_rs)]
    check(oks == [1, 1, 1], f"fabric: ok flags {oks} in rank {rank}")
    check(torch.equal(y, everyone[(rank - 1) % world]), "fabric: neighbor_exchange")
    check(torch.equal(gathered, everyone.reshape(-1)), "fabric: ring_all_gather")
    rows = n // world
    want = everyone[:, rank * rows:(rank + 1) * rows].sum(0)
    rec["reduce_scatter_err"], good = _close(shard, want, 1e-5)
    check(good, f"fabric: reduce_scatter_ring off by {rec['reduce_scatter_err']}")
    check(torch.equal(a2a, everyone.view(world, world, -1)[:, rank]),
          "fabric: all_to_all")
    # a flipped bit in a received 64 MiB buffer fails its MAC
    got, _ = neighbor_exchange(fab, raw, raw_key, x)
    mac, _ = neighbor_exchange(fab, raw, raw_key,
                               attach_mac(x, chan.seed).view(torch.int32).reshape(1))
    bad = got.clone()
    bad.view(torch.int32)[n // 2 + rank] ^= 1 << (rank + 7)
    flags = [int(verify_mac(t, mac, chan.seed).item()) for t in (got, bad)]
    check(flags == [1, 0], f"fabric: MAC of a clean / flipped hop gave {flags}")
    want_macs = 2 * (1 + 2 * (world - 1))
    check(rec["launches"]["mac_batch"] == want_macs,
          f"fabric: {rec['launches']['mac_batch']} mac_batch launches, "
          f"want {want_macs}")
    return rec


def _fabric_ring(rank, world, fab, chan, key):
    from repro_torch.core.ring_attention import ring_attention
    from repro_torch.kernels import ops
    B, S, H, Hkv, Dh = 2, 8192, 32, 8, 64         # llama3.2-1b's attention
    g = torch.Generator(device="cuda").manual_seed(SEED + 200)
    q = torch.randn(B, S, H, Dh, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, S, Hkv, Dh, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, S, Hkv, Dh, generator=g, device="cuda").bfloat16()
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    blk = slice(rank * S // world, (rank + 1) * S // world)
    local = [t[:, blk].contiguous() for t in (q, k, v, pos)]
    recs = {}
    for name, causal, window in (("causal", True, None), ("window_4096", True, 4096),
                                 ("non_causal", False, None)):
        rec = {"B": B, "S": S, "S_a_rank": S // world, "H": H, "Hkv": Hkv, "Dh": Dh}
        with _Case(rec):
            out, ok = ring_attention(fab, chan, key, *local[:3], local[3], local[3],
                                     causal=causal, window=window)
        want = ops.attention(q, k, v, pos, pos, causal=causal, window=window)[:, blk]
        rec["max_abs_err"], good = _close(out, want, 2e-2)
        check(good and int(ok.item()) == 1,
              f"fabric: ring attention {name} off by {rec['max_abs_err']}")
        n = rec["launches"]
        check(n["flash_attention"] == world and n["mac_batch"] == 2 * 3 * (world - 1),
              f"fabric: ring attention {name} launches {n}")
        recs[name] = rec
    return recs


def _fabric_moe(rank, world, mesh):
    from repro_torch.configs import get_config, replace
    from repro_torch.core.fabric import MPKLinkFabric
    from repro_torch.models.moe import apply_moe, init_moe_stack
    from repro_torch.models.moe_ep import apply_moe_ep, split_expert_weights
    from repro_torch.tree import map_tree
    cfg = get_config("mixtral-8x7b")
    S = 2048
    gen = torch.Generator(device="cuda").manual_seed(SEED + 300)
    w = map_tree(lambda a: a[0], init_moe_stack(cfg, gen, 1, torch.bfloat16))
    x = torch.randn(world, S, cfg.d_model, generator=gen, device="cuda").bfloat16()
    fab = MPKLinkFabric(mesh)
    chan, key = fab.establish("moe-dispatch", "x")
    local = split_expert_weights(w, world, rank)
    rec = {"d_model": cfg.d_model, "d_ff": cfg.d_ff, "experts": cfg.moe.num_experts,
           "experts_a_rank": cfg.moe.num_experts // world, "tokens_a_rank": S,
           "expert_bytes_a_rank": sum(local[n].nbytes for n in ("gate", "up", "down"))}
    with _Case(rec):
        y, aux = apply_moe_ep(cfg, local, x[rank:rank + 1], fabric=fab, chan=chan,
                              key=key)
    dense = replace(cfg, moe=replace(cfg.moe, group_size=S))
    want, aux_want = apply_moe(dense, w, x[rank:rank + 1])
    rec["max_abs_err"], good = _close(y, want, 2e-2)
    rec["drop_frac"] = aux["moe_drop_frac"].item()
    check(good and rec["drop_frac"] == aux_want["moe_drop_frac"].item(),
          f"fabric: apply_moe_ep off by {rec['max_abs_err']}")
    return rec


def _fabric_pipeline(rank, world, mesh):
    from repro_torch.configs import get_config
    from repro_torch.core.fabric import MPKLinkFabric
    from repro_torch.models.transformer import Impl, apply_block, init_stack, layers
    from repro_torch.runtime.pipeline import pipeline_apply, stage_split
    from repro_torch.tree import leaves, map_tree
    cfg = get_config("llama3.2-1b")
    n_micro, mb, S = 4, 2, 2048
    gen = torch.Generator(device="cuda").manual_seed(SEED + 400)
    stacked = init_stack(cfg, gen, cfg.num_layers, torch.bfloat16)
    xm = torch.randn(n_micro, mb, S, cfg.d_model, generator=gen,
                     device="cuda").bfloat16()
    per = cfg.num_layers // world
    local = map_tree(lambda a: a[rank].clone().requires_grad_(),
                     stage_split(stacked, world))
    fab = MPKLinkFabric(mesh, guard=True)
    chan, key = fab.establish("stage-handoff", "x")
    rec = {"layers": cfg.num_layers, "stages": world, "n_micro": n_micro,
           "microbatch": [mb, S]}
    with _Case(rec):
        outs, ok = pipeline_apply(cfg, local, xm, fabric=fab, chan=chan, key=key,
                                  impl=Impl())
        (outs.float() ** 2).sum().backward()
    check(int(ok.item()) == 1, "fabric: pipeline ok flag")
    ticks = n_micro + world - 1
    n = rec["launches"]
    check(n["flash_attention"] == ticks * per and n["flash_attention_bwd"] == ticks * per
          and n["mac_batch"] == 2 * ticks, f"fabric: pipeline launches {n}")
    # the stack in one rank: this stage's blocks take gradients, the later
    # ones carry them back, the earlier ones run without a graph
    mine = map_tree(lambda a: a[rank].clone().requires_grad_(),
                    stage_split(stacked, world))
    blocks = layers(stacked)
    own = layers(mine)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(mb, S)
    errs = []
    for m in range(n_micro):
        h = xm[m]
        with torch.no_grad():
            for p in blocks[:rank * per]:
                h, _ = apply_block(cfg, p, h, positions=pos, impl=Impl())
        for p in own + blocks[(rank + 1) * per:]:
            h, _ = apply_block(cfg, p, h, positions=pos, impl=Impl())
        errs.append(_close(outs[m].detach(), h.detach(), 2e-2))
        (h.float() ** 2).sum().backward()
    rec["max_abs_err"] = max(e for e, _ in errs)
    cos = [torch.nn.functional.cosine_similarity(
        a.grad.flatten().double(), b.grad.flatten().double(), dim=0).item()
        for a, b in zip(leaves(local), leaves(mine))]
    rec["min_grad_cosine"] = min(cos)
    check(all(g for _, g in errs) and min(cos) >= 0.99,
          f"fabric: pipeline off by {rec['max_abs_err']}, cosine {min(cos)}")
    return rec


def _fabric_compression(rank, world, mesh):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_stack
    from repro_torch.optim import compressed_tree_reduce, init_error_feedback
    from repro_torch.tree import leaves, map_tree
    cfg = get_config("llama3.2-1b")

    def grads(r):
        return map_tree(lambda a: a[0].float(), init_stack(
            cfg, torch.Generator(device="cuda").manual_seed(SEED + 500 + r), 1))

    g = grads(rank)
    ef = init_error_feedback(g, world)
    rec = {"values": sum(t.numel() for t in leaves(g))}
    with _Case(rec):
        red, new_ef = compressed_tree_reduce(g, ef, mesh.get_group("x"))
    exact = [torch.stack(ls).mean(0) for ls in
             zip(*(leaves(grads(r)) for r in range(world)))]
    worst = 0.0
    for got, want in zip(leaves(red), exact):
        rows = want.shape[0] // world
        for j in range(world):
            shard = want[j * rows:(j + 1) * rows]
            step = shard.abs().max().item() / 127.0
            err = (got[j * rows:(j + 1) * rows] - shard).abs().max().item()
            worst = max(worst, err / step)
    rec["err_over_int8_step"] = worst            # the bound: one half step
    rec["residual_max"] = max(t.abs().max().item() for t in leaves(new_ef))
    check(worst <= 0.5 + 1e-3 and rec["residual_max"] > 0,
          f"fabric: compressed reduce {worst} int8 steps off, residual "
          f"{rec['residual_max']}")
    return rec


SHARDING_ARCH = "llama3.2-1b"


def write_sharding_checkpoint():
    """A full-width llama3.2-1b checkpoint (bf16 parameters, random from a
    seeded generator on the card) in a fresh temporary directory, written
    by the port's ``Checkpointer`` → (directory, seconds)."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    params = init_params(get_config(SHARDING_ARCH),
                         torch.Generator(device="cuda").manual_seed(SEED + 7),
                         dtype=torch.bfloat16)
    path = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    Checkpointer(path).save(3, params, blocking=True)
    del params
    torch.cuda.empty_cache()
    return path, time.perf_counter() - t0


def _spec_slice(spec, at, sizes, shape):
    """The index of the shard at mesh coordinate ``at`` under ``spec``,
    each split dim in equal parts, its first axis major (written here
    apart from ``sharding.local_slice``, which it checks)."""
    index = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        parts, i = 1, 0
        for ax in axes:
            parts, i = parts * sizes[ax], i * sizes[ax] + at[ax]
        index.append(slice(i * (n // parts), (i + 1) * (n // parts)))
    return tuple(index)


def _sharding_case(rank, world, ckpt_dir):
    """This rank's part of the sharding line: the checkpoint restored by
    ``elastic_restore`` onto a (2, 2) ("data", "model") mesh under fsdp_tp,
    then onto ``remesh(2, tp=2)``'s (1, 2) mesh (ranks 2 and 3 take part in
    building it and hold no shard). Every local shard against the slice of
    the checkpoint's npz entry read apart from the restore: bits, shape
    (``local_shape``), placements and device."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.device import MetaGenerator
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    from repro_torch.runtime.elastic import elastic_restore, remesh
    from repro_torch.sharding import local_shape, mesh_sizes, param_specs, placements
    from repro_torch.tree import leaves_with_paths
    cfg = get_config(SHARDING_ARCH)
    like = init_params(cfg, MetaGenerator(), dtype=torch.bfloat16)
    paths = sorted(p for p, _ in leaves_with_paths(like))
    out = {}
    for name, make in (("mesh_2x2", lambda: make_test_mesh((2, 2), ("data", "model"))),
                       ("remesh_1x2", lambda: remesh(2, tp=2))):
        mesh = make()
        coord = mesh.get_coordinate()
        if coord is None:
            out[name] = None
            dist.barrier()
            continue
        spec_tree = param_specs(cfg, like, policy="fsdp_tp", mesh=mesh)
        specs = dict(leaves_with_paths(spec_tree))
        t0 = time.perf_counter()
        step, placed = elastic_restore(Checkpointer(ckpt_dir), like, mesh, spec_tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        placed = dict(leaves_with_paths(placed))
        at, sizes = dict(zip(mesh.mesh_dim_names, coord)), mesh_sizes(mesh)
        wrong, local_bytes = [], 0
        with np.load(os.path.join(ckpt_dir, f"step_{step}", "arrays.npz")) as z:
            for i, path in enumerate(paths):
                t, spec = placed[path], specs[path]
                local = t.to_local()
                full = z[f"{i:06d}"].view(np.int16)
                want = full[_spec_slice(spec, at, sizes, full.shape)]
                ok = (local.is_cuda and local.dtype == torch.bfloat16
                      and tuple(local.shape) == local_shape(t.shape, spec, sizes)
                      and list(t.placements) == placements(spec, mesh)
                      and np.array_equal(local.view(torch.int16).cpu().numpy(), want))
                if not ok:
                    wrong.append(path)
                local_bytes += local.numel() * 2
        out[name] = dict(coord=list(coord), step=step, leaves=len(paths), wrong=wrong,
                         local_bytes=local_bytes, restore_s=restore_s)
        del placed
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def fabric_rank(rank, world, t_start, ckpt_dir):
    """One rank of the fabric phase (a process of its own on the card),
    then its part of the sharding line (``_sharding_case``)."""
    from repro_torch.core.fabric import MPKLinkFabric
    from repro_torch.launch.mesh import make_test_mesh
    started = time.time() - t_start
    gloo_cuda = _gloo_takes_cuda(rank, world)
    mesh = make_test_mesh((world,), ("x",))
    fab = MPKLinkFabric(mesh, guard=True)
    chan, key = fab.establish("tp", "x")
    raw, raw_key = fab.establish("raw", "x", guard=False)
    ring, ring_key = fab.establish("ring-kv", "x")
    cases = {"collectives": _fabric_collectives(rank, world, fab, chan, key, raw,
                                                raw_key)}
    cases.update({f"ring_attention_{k}": v
                  for k, v in _fabric_ring(rank, world, fab, ring, ring_key).items()})
    torch.cuda.empty_cache()
    cases["moe_ep"] = _fabric_moe(rank, world, mesh)
    torch.cuda.empty_cache()
    cases["pipeline"] = _fabric_pipeline(rank, world, mesh)
    torch.cuda.empty_cache()
    cases["compressed_tree_reduce"] = _fabric_compression(rank, world, mesh)
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    return {"started_s": started, "gloo_cuda": gloo_cuda, "cases": cases,
            "peak_mem_gb": peak, "sharding": _sharding_case(rank, world, ckpt_dir)}


def phase_fabric(smi):
    """The device fabric on the one card: four ranks (processes from the
    forkserver, each on ``cuda:0``) over gloo, every exchange staged
    through pinned host buffers; every case held against the same
    computation in one rank. Then, in the same world, the sharding line:
    a full-width llama3.2-1b checkpoint placed by ``elastic_restore`` on a
    (2, 2) mesh under fsdp_tp and on the (1, 2) remesh, every rank's shard
    equal to the checkpoint's slice bit for bit. → the kernel launches of
    the fabric cases."""
    import shutil
    from repro_torch.launch.world import run_world
    torch.cuda.empty_cache()
    ckpt_dir, ckpt_s = write_sharding_checkpoint()
    t0 = time.perf_counter()
    try:
        ranks = run_world(fabric_rank, FABRIC_WORLD, time.time(), ckpt_dir,
                          device="cuda", timeout=600)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    cases = {}
    for name in ranks[0]["cases"]:
        per = [r["cases"][name] for r in ranks]
        rec = dict(per[0])
        rec["wall_ms"] = max(p["wall_ms"] for p in per)
        for k in ("hops", "collectives", "sent_bytes", "staged_bytes"):
            rec[k] = sum(p[k] for p in per)
        rec["launches"] = {k: sum(p["launches"][k] for p in per) for k in FABRIC_KERNELS}
        for k in ("max_abs_err", "reduce_scatter_err", "err_over_int8_step"):
            if k in rec:
                rec[k] = max(p[k] for p in per)
        if "min_grad_cosine" in rec:
            rec["min_grad_cosine"] = min(p["min_grad_cosine"] for p in per)
        cases[name] = rec
    launches = {k: sum(c["launches"][k] for c in cases.values()) for k in FABRIC_KERNELS}
    emit(phase="fabric", card=smi, world=FABRIC_WORLD, backend="gloo",
         gloo_takes_cuda=ranks[0]["gloo_cuda"],
         rank_start_s=max(r["started_s"] for r in ranks),
         peak_mem_gb_a_rank=max(r["peak_mem_gb"] for r in ranks),
         cases=cases, launches=launches, wall_s=wall)
    meshes = {}
    for name in ("mesh_2x2", "remesh_1x2"):
        per = [r["sharding"][name] for r in ranks]
        holders = [rank for rank, p in enumerate(per) if p is not None]
        check(holders == ([0, 1, 2, 3] if name == "mesh_2x2" else [0, 1]),
              f"sharding {name}: ranks {holders} hold shards")
        for rank in holders:
            check(not per[rank]["wrong"] and per[rank]["step"] == 3,
                  f"sharding {name}: rank {rank}'s shards of {per[rank]['wrong']} "
                  f"differ from the checkpoint")
        meshes[name] = dict(coords=[per[r]["coord"] for r in holders],
                            leaves=per[holders[0]]["leaves"],
                            local_bytes=[per[r]["local_bytes"] for r in holders],
                            restore_s=max(per[r]["restore_s"] for r in holders))
    emit(phase="sharding", card=smi, arch=SHARDING_ARCH, dtype="bfloat16",
         policy="fsdp_tp", world=FABRIC_WORLD, backend="gloo", checkpoint_s=ckpt_s,
         meshes=meshes, bit_identical=True)
    return launches


def phase_ipc(smi):
    """``launch.ipc_wordcount`` on the card: the six transports at 1e2 to
    1e7 words (3 reps, median) and uds, mpklink and mpklink_opt at 1e8 (1
    rep), every count exact and every key-sync and guard-launch count as
    the code gives it (checked in ``measure``); shm refuses >= 1e5 words
    with CapacityError; mpklink_opt syncs <= 3 times a request; frames
    sealed in card regions verify bit for bit on the CPU and a tampered
    region is refused; then 1 and 16 concurrent mpklink_opt sessions of
    8 x 1e4 words through their rings. Claims 1, 2 and 5 (timings) are printed as
    PASS/FAIL lines, not asserted. → the guard-kernel launches of the
    measured runs."""
    from repro_torch.launch import ipc_wordcount as ipc

    launches, records = {}, []
    cpus = os.cpu_count()

    def point(rec):
        for k, v in rec.get("launches_per_request", {}).items():
            launches[k] = launches.get(k, 0) + int(v * rec["reps"])
        records.append(rec)
        emit(phase="ipc", card=smi, cpu_count=cpus, **rec)

    t0 = time.perf_counter()
    results = ipc.sweep(ipc.WORD_COUNTS_FULL, reps=3, device="cuda",
                        endpoint=True, emit=point)
    for n, t in results["shm"].items():
        check((t is None) == (n >= 100_000),
              f"shm at {n} words: {'refused' if t is None else 'served'}")
    for name in ipc.ORDER:
        for n, t in results[name].items():
            check(name == "shm" or t is not None, f"{name} refused {n} words")
    check(all(r["key_syncs_per_request"] <= 3 for r in records
              if r["transport"] == "mpklink_opt"), "mpklink_opt: > 3 syncs a request")
    regions = ipc.region_checks("cuda")
    claims = ipc.validate_claims(results, "cuda")
    for line in claims:
        print(f"# {line} (cpu_count {cpus}; {smi})", flush=True)
    check(all("PASS" in c for c in claims if c.startswith(("claim3", "claim4"))),
          "claim 3 or 4 failed")
    for n_sessions in (1, 16):
        conc = ipc.concurrent_sessions(n_sessions, 8, 10_000, rounds=4, device="cuda")
        for k, v in conc.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        emit(phase="ipc_concurrent", card=smi, cpu_count=cpus, **conc)
    emit(phase="ipc_done", card=smi, cpu_count=cpus, regions=regions,
         claims=claims, rows=[list(r) for r in ipc.table_rows(results)],
         wall_s=time.perf_counter() - t0)
    return launches


def state_bytes(tree):
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def dry_run(cfg, kind, B, S, ms, launches, calls, **kw):
    """The dry run's numbers for a train or prefill line (``launch.dryrun``:
    the same step on the meta device, one card, its kernels counted by their
    ``cost``) beside the line's measured ``ms``: bytes of state and of one
    microbatch's saved activations, FLOPs, the roofline bound, the MFU
    (``model_flops`` over ms at the bf16 peak), and the bound's and the
    compute term's shares of the measured time. The memory term counts
    every op's operands and results, an upper bound on the bytes moved, so
    ``dry_bound_ms`` is no floor when memory bounds it
    (``dry_bytes_upper_bound``); ``compute_share`` reads the FLOPs alone.
    Each kernel's launches in one dry step times ``calls`` must equal the
    measured ``launches``."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import model_flops
    t0 = time.perf_counter()
    r = dryrun.count_step(cfg, kind, B, S, dtype=torch.bfloat16, **kw)
    roof = r["cost"].roofline()
    dry = {k: v["launches"] for k, v in r["cost"].kernels.items()}
    for name, n in dry.items():
        check(n * calls == launches[name],
              f"{cfg.name} {kind} dry run: {n} {name} launches a step, measured "
              f"{launches[name]} in {calls}")
    mfl = model_flops(cfg.active_param_count(), B * S, kind)
    return dict(dry_state_bytes=r["state_bytes"], dry_act_bytes=r["act_bytes"],
                dry_flops=roof.flops, dry_bytes=roof.hbm_bytes,
                dry_bytes_upper_bound=True, dry_bound_ms=roof.t_bound * 1e3,
                dry_bound_by=roof.bottleneck, dry_compute_ms=roof.t_compute * 1e3,
                model_flops=mfl, mfu=mfl / (ms / 1e3 * PEAK_FLOPS["bf16"]),
                roofline_share=roof.t_bound / (ms / 1e3),
                compute_share=roof.t_compute / (ms / 1e3), dry_launches=dry,
                dry_s=time.perf_counter() - t0)


def phase_decode(cfg, B=8, max_seq=448, ticks=64, warm=2):
    """Uniform decode through ``make_decode_step`` at full width and depth
    (bf16): B rows, ``ticks`` ticks after ``warm`` unmeasured ones, every
    row at the same position. An encoder-decoder first encodes B x enc_ctx
    frames (outside the count) and builds its cross K/V once. A window
    shorter than ``max_seq`` decodes on a ring cache, filled before the
    run: random K/V and the slot positions of a ring that has wrapped 7
    times (every slot valid and inside the window, the tick's full work),
    decoding on from position 7 W. Decode attention must launch once per
    attention block a tick; the logits must be finite; the ring's slots
    must hold the positions written. ms per tick beside the floor (the
    weights and the state's valid K/V read once at 3.35 TB/s), the state's
    bytes and, for a ring, those of the dense cache it stands for."""
    from repro_torch.kernels import ops
    from repro_torch.models import Impl, init_decode_state, init_params
    from repro_torch.models.model import encode
    from repro_torch.runtime.steps import make_decode_step

    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(8),
                         dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    kw = {}
    if cfg.enc_dec:
        frames = model_batch(cfg, B, 1, gen)["frames"]
        with torch.no_grad():
            kw = dict(params=params, enc_out=encode(cfg, params, frames))
    state = init_decode_state(cfg, B, max_seq, dtype=torch.bfloat16, device="cuda", **kw)
    caches = state["caches"]
    ring = "slot_pos" in caches
    start = 0
    if ring:
        W = cfg.swa_window
        start = 7 * W
        for leaf in (caches["k"], caches["v"]):
            for layer_cache in leaf:
                layer_cache.copy_(torch.randn(layer_cache.shape, generator=gen,
                                              device="cuda"))
        caches["slot_pos"].copy_((start - W + torch.arange(
            W, dtype=torch.int32, device="cuda"))[None].expand(cfg.num_layers, W))
        state["pos"] = start
    step = make_decode_step(cfg, Impl(), dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (B, warm + ticks), generator=gen,
                         device="cuda")
    for t in range(warm):
        logits, state = step(params, state, toks[:, t:t + 1])
    torch.cuda.synchronize()
    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    for t in range(warm, warm + ticks):
        logits, state = step(params, state, toks[:, t:t + 1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES.snapshot()
    n = decode_blocks(cfg)
    check(launches["decode_attention"] == n * ticks,
          f"{cfg.name} decode: {launches['decode_attention']} decode-attention "
          f"launches in {ticks} ticks, want {n} a tick")
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          f"{cfg.name} decode: non-finite logits")
    check(state["pos"] == start + warm + ticks, f"{cfg.name} decode: pos {state['pos']}")
    L, Hkv, Dh = cfg.num_layers, cfg.kv_heads_eff, cfg.head_dim
    kv_row = 2 * Hkv * Dh * 2                         # k and v of one slot, bf16
    extra = {}
    if ring:
        W = cfg.swa_window
        last = start + warm + ticks - 1
        want = torch.tensor([p - W if p > last else p
                             for p in range(start, start + W)], dtype=torch.int32)
        want = want.roll(start % W)
        check(torch.equal(caches["slot_pos"][0].cpu(), want)
              and torch.equal(caches["slot_pos"][-1].cpu(), want),
              f"{cfg.name} decode: the ring's slot positions are not the ones written")
        valid = L * B * W * kv_row
        extra = dict(ring_window=W, start_pos=start,
                     dense_cache_bytes=L * B * max_seq * kv_row)
    else:
        valid = L * B * (start + warm + ticks) * kv_row
        if cfg.enc_dec:
            valid += state_bytes(caches["cross"])
    weight_bytes = state_bytes(params)
    ms = wall / ticks * 1e3
    emit(phase="decode", arch=cfg.name, layers=L, d_model=cfg.d_model, dtype="bfloat16",
         batch=B, max_seq=max_seq, ticks=ticks, ring=ring, ms_per_tick=ms,
         tokens_per_s=B * ticks / wall,
         floor_ms=(weight_bytes + valid) / HBM_BW * 1e3,
         weight_bytes=weight_bytes, state_bytes=state_bytes(caches), launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **extra)
    del params, state, caches, kw
    torch.cuda.empty_cache()
    return launches


def phase_ring_parity(cfg, B=2, extra=256):
    """A windowed model in f32 at full width (cut in depth by the caller):
    ``W + extra`` tokens decoded one by one on a ring cache of W slots (the
    ring wraps), against the forward over the same tokens with the window,
    both through the kernels: the same argmax wherever the top two logits
    are more than 100x the largest difference apart (near ties counted),
    every logit within 3e-4 (the JAX package's ring test), decode attention
    once per layer a token. → the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import Impl, decode_step, forward, init_decode_state, init_params

    W, V = cfg.swa_window, cfg.vocab_size
    n = W + extra
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(9),
                         dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    toks = torch.randint(0, V, (B, n), generator=gen, device="cuda")
    with torch.no_grad():
        want = forward(cfg, params, {"tokens": toks}, impl=Impl(),
                       dtype=torch.float32)[0][..., :V]
    st = init_decode_state(cfg, B, 2 * W, dtype=torch.float32, device="cuda")
    check(st["caches"]["slot_pos"].shape == (cfg.num_layers, W), "no ring cache")
    got = torch.empty_like(want)
    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(n):
            lg, st = decode_step(cfg, params, st, toks[:, t:t + 1], impl=Impl(),
                                 dtype=torch.float32)
            got[:, t] = lg[:, 0, :V]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES.snapshot()
    check(launches["decode_attention"] == cfg.num_layers * n,
          f"ring parity: {launches['decode_attention']} decode launches for {n} tokens")
    err = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 100 * err
    same = got.argmax(-1) == want.argmax(-1)
    check(bool(torch.isfinite(got).all()) and bool(same[decided].all()) and err <= 3e-4,
          f"{cfg.name}: ring decode and the windowed forward disagree (max err {err})")
    tail = (got[:, W:] - want[:, W:]).abs().max().item()
    emit(phase="ring_parity", arch=cfg.name, layers=cfg.num_layers, dtype="float32",
         batch=B, window=W, tokens=n, wraps=n // W, max_abs_diff=err,
         max_abs_diff_past_wrap=tail, argmax_identical=bool(same.all()),
         near_ties=int((~decided).sum()), ms_per_token=wall / n * 1e3, launches=launches)
    del params, st, want, got
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 4. train at full width
# ---------------------------------------------------------------------------

def phase_train(cfg, steps=6, batch=8, seq=2048, micro=2,
                param_dtype=torch.float32, opt_dtype=torch.float32, remat=False,
                beside=None, published=None):
    """The port's ``Trainer`` at full width (the depth the caller gives):
    ``param_dtype`` parameters, ``opt_dtype`` AdamW moments, bf16 compute,
    a global batch of ``batch`` x ``seq`` in microbatches of ``micro``,
    ``steps`` steps at lr 3e-4 with 2 warmup steps on the
    ``SyntheticDataset``, each layer under remat where asked. The launch
    counts are zeroed just before and read just after; every attention and
    mamba block of every microbatch must run its kernel's backward once and
    its forward once, twice under remat (the recompute). ``beside``: fields
    of an earlier line of this run to print beside this one. The dry run's
    numbers for the same step join the line (``dry_run``); its bytes of
    state must equal the line's. A model cut in depth gives its
    ``published`` config: the cut must be at most the dry run's
    ``fits_depth`` of that config on this card. → (the launch counts, the
    peak memory in GB)."""
    from repro_torch.configs import OptimizerConfig, TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_bytes_per_param
    from repro_torch.models import Impl
    from repro_torch.runtime import Trainer, TrainReport, make_prefill_step
    from repro_torch.tree import leaves

    tcfg = TrainConfig(microbatch_size=micro, dtype="bfloat16",
                       param_dtype=str(param_dtype).removeprefix("torch."),
                       optimizer=OptimizerConfig(lr=3e-4, warmup_steps=2,
                                                 total_steps=steps),
                       log_every=0, seed=0)
    trainer = Trainer(cfg, tcfg, global_batch=batch, seq_len=seq, device="cuda",
                      impl=Impl(remat=remat), opt_dtype=opt_dtype)
    state = trainer.init_state(seed=5)
    n_params = sum(p.numel() for p in leaves(state["params"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    report = TrainReport()
    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    trainer.run(1, state=state, report=report)          # the first step: warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.run(steps, state=state, start_step=1, report=report)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.LAUNCHES.snapshot()
    runs = (batch // micro) * steps
    losses = report.losses
    check(report.steps_run == steps and all(map(math.isfinite, losses)),
          f"{cfg.name} train: {report.steps_run} steps, losses {losses}")
    check(losses[-1] < losses[0], f"{cfg.name} train: the loss did not fall: {losses}")
    for kernel, per_call in layer_kernels(cfg).items():
        for name, times in ((kernel, 2 if remat else 1), (f"{kernel}_bwd", 1)):
            check(launches[name] == per_call * runs * times,
                  f"{cfg.name} train: {launches[name]} {name} launches, want "
                  f"{per_call * runs * times}")
    check(all(p.dtype == param_dtype for p in leaves(state["params"]))
          and all(m.dtype == opt_dtype for m in leaves(state["opt"]["m"])),
          f"{cfg.name} train: the state left its dtypes")
    ms = (t2 - t1) / (steps - 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 80, f"{cfg.name} train: peak {peak} GB")
    n_state = n_params * train_bytes_per_param(param_dtype, opt_dtype, batch // micro)
    kw = dict(micro=micro, param_dtype=param_dtype, opt_dtype=opt_dtype,
              impl=Impl(remat=remat))
    dry = dry_run(cfg, "train", batch, seq, ms, launches, steps, **kw)
    check(dry["dry_state_bytes"] == n_state,
          f"{cfg.name} train: dry run {dry['dry_state_bytes']} bytes of state, "
          f"the card's {n_state}")
    dry["dry_state_plus_act_gb"] = (dry["dry_state_bytes"] + dry["dry_act_bytes"]) / 1e9
    if published is not None:
        from repro_torch.launch import dryrun
        capacity, card = dryrun.card_capacity()
        plan = dryrun.fits_depth(published, "train", batch, seq, capacity,
                                 dtype=torch.bfloat16, **kw)
        check(cfg.num_layers <= plan["fits_depth"],
              f"{cfg.name} train: {cfg.num_layers} layers, more than the dry run's "
              f"fits_depth {plan['fits_depth']} on {card}")
        dry.update(dry_fits_depth=plan["fits_depth"], published_layers=published.num_layers,
                   dry_need_bytes_published=plan["need_bytes"], capacity_bytes=capacity)
    emit(phase="train", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         params=n_params, param_dtype=tcfg.param_dtype,
         moment_dtype=str(opt_dtype).removeprefix("torch."), compute_dtype="bfloat16",
         remat=remat, state_bytes=n_state,
         global_batch=batch, seq_len=seq, microbatch=micro, steps=steps, lr=3e-4,
         warmup_steps=2, vision_tokens=cfg.vision_tokens or None, losses=losses,
         first_step_s=t1 - t0, ms_per_step=ms, tokens_per_s=batch * seq / ms * 1e3,
         peak_mem_gb=peak, launches=launches, **dry, **(beside or {}))
    # the trained state serves without a graph: the step put requires_grad back
    check(not any(p.requires_grad for p in leaves(state["params"])),
          "train: the step left the parameters requiring grad")
    prompt = model_batch(cfg, 1, 128, torch.Generator(device="cuda").manual_seed(SEED))
    prompt.pop("vision_embeds", None)                    # text: 128 < the prefix
    logits = make_prefill_step(cfg)(state["params"], prompt)
    check(logits.grad_fn is None and bool(torch.isfinite(logits).all()),
          "train: a prefill of the trained state built a graph or is not finite")
    del trainer, state, logits
    torch.cuda.empty_cache()
    return launches, peak


def phase_remat(cfg, batch=8, seq=2048, micro=2, peak_drops=True):
    """Remat against no remat at full width: one train step of ``batch`` x
    ``seq`` (microbatches of ``micro``) each way from the same state, seed
    and data (losses, peaks, launches: the forward kernels twice under
    remat, the backward once), and the gradients of the step's first
    microbatch each way, equal bit for bit (the recompute runs the same
    kernels on the same inputs, and a MoE layer's routing picks the same
    experts). With ``peak_drops`` the step's peak must be lower under
    remat; without it the peak is printed only (mixtral-8x7b's 2 layers at
    1 x 4224: the state and the gradients set the step's peak, 53.97 GB
    either way on an H100 80GB HBM3 at 700 W). → the launch counts of the
    two steps."""
    from repro_torch.configs import OptimizerConfig, TrainConfig
    from repro_torch.data import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import Impl, loss_fn
    from repro_torch.runtime import Trainer, TrainReport
    from repro_torch.tree import leaves

    tcfg = TrainConfig(microbatch_size=micro, dtype="bfloat16",
                       optimizer=OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=6),
                       log_every=0, seed=0)
    runs = batch // micro
    out, total = {}, {}
    for remat in (False, True):
        trainer = Trainer(cfg, tcfg, global_batch=batch, seq_len=seq, device="cuda",
                          impl=Impl(remat=remat))
        state = trainer.init_state(seed=5)
        mb = to_device(trainer.dataset.batch(0, micro), "cuda")
        flat = [p.requires_grad_(True) for p in leaves(state["params"])]
        loss, _ = loss_fn(cfg, state["params"], mb, impl=Impl(remat=remat),
                          dtype=torch.bfloat16)
        grads = [g.cpu() for g in torch.autograd.grad(loss, flat)]   # off the peak
        for p in flat:
            p.requires_grad_(False)
        del loss
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        report = TrainReport()
        ops.LAUNCHES.reset()
        t0 = time.perf_counter()
        trainer.run(1, state=state, report=report)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES.snapshot()
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        for kernel, per_call in layer_kernels(cfg).items():
            for name, times in ((kernel, 2 if remat else 1), (f"{kernel}_bwd", 1)):
                check(launches[name] == per_call * runs * times,
                      f"{cfg.name} remat {remat}: {launches[name]} {name} launches, "
                      f"want {per_call * runs * times}")
        out[remat] = dict(loss=report.losses[0], grads=grads, s=wall,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          launches=launches)
        del trainer, state, flat
        torch.cuda.empty_cache()
    off, on = out[False], out[True]
    identical = all(torch.equal(a, b) for a, b in zip(on["grads"], off["grads"]))
    rel = 0.0 if identical else max(
        ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        for a, b in zip(on["grads"], off["grads"]))
    check(identical and on["loss"] == off["loss"],
          f"{cfg.name} remat: losses {on['loss']} / {off['loss']}, gradients differ "
          f"by {rel} of a leaf's largest |g|")
    check(not peak_drops or on["peak_mem_gb"] < off["peak_mem_gb"],
          f"{cfg.name} remat: peak {on['peak_mem_gb']} GB, without {off['peak_mem_gb']}")
    emit(phase="remat", arch=cfg.name, layers=cfg.num_layers, global_batch=batch,
         seq_len=seq, microbatch=micro, dtype="bfloat16", loss=off["loss"],
         loss_remat=on["loss"], max_grad_rel_diff=rel, grads_identical=identical,
         step_s=off["s"], step_s_remat=on["s"], peak_mem_gb=off["peak_mem_gb"],
         peak_mem_gb_remat=on["peak_mem_gb"], launches=off["launches"],
         launches_remat=on["launches"])
    del out, off, on
    torch.cuda.empty_cache()
    return total


def _cosine(a, b, piece=1 << 25):
    """Cosine similarity of two tensors of one shape, on the card in f64,
    a piece at a time (either may live on the host)."""
    a, b = a.reshape(-1), b.reshape(-1)
    dots = torch.zeros(3, dtype=torch.float64, device="cuda")
    for i in range(0, a.numel(), piece):
        x = a[i:i + piece].to("cuda").double()         # widened on the card
        y = b[i:i + piece].to("cuda").double()
        dots += torch.stack([x @ y, x @ x, y @ y])
    ab, aa, bb = dots.tolist()
    return ab / max(math.sqrt(aa * bb), 1e-300)


def phase_grad_parity(cfg, S=512, host=False):
    """One microbatch of 1 x ``S`` at full width: loss and gradients
    through the kernels in bf16 against the plain versions in f32
    (``Impl(attention="plain", ssd="plain")``, f32 parameters both times):
    the loss to 2e-2 relative, and every gradient leaf at cosine >= 0.99
    with its f32 counterpart. ``min_cosine_plain_bf16`` is the same
    measure for the plain versions in bf16: the share of the bf16 gap that
    is not the kernels'. The f32 gradients are kept (on the host with
    ``host``: grok-1-314b's layer is 26 GB of f32 parameters and 26 GB a
    set of gradients, and two sets beside the parameters do not fit), the
    others compared with them as they come."""
    from repro_torch.data import SyntheticDataset, to_device
    from repro_torch.models import Impl, init_params, loss_fn
    from repro_torch.tree import leaves_with_paths

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(6))
    batch = to_device(SyntheticDataset(cfg, S, seed=1).batch(0, 1), "cuda")
    flat = [p.requires_grad_(True) for _, p in leaves_with_paths(params)]
    names = [n for n, _ in leaves_with_paths(params)]
    plain = Impl(attention="plain", ssd="plain")
    torch.cuda.reset_peak_memory_stats()

    def grads_of(impl, dtype):
        loss, _ = loss_fn(cfg, params, batch, impl=impl, dtype=dtype)
        return loss.item(), torch.autograd.grad(loss, flat)

    lf, gf = grads_of(plain, torch.float32)
    if host:
        gf = [g.cpu() for g in gf]
    lb, grads = grads_of(Impl(), torch.bfloat16)
    cos = {n: _cosine(a, b) for n, a, b in zip(names, grads, gf)}
    del grads
    _, grads = grads_of(plain, torch.bfloat16)
    cos_plain = min(_cosine(a, b) for a, b in zip(grads, gf))
    del grads
    rel = abs(lb - lf) / abs(lf)
    check(rel <= 2e-2, f"{cfg.name} grad parity: bf16 loss {lb} vs f32 {lf} ({rel})")
    check(all(c >= 0.99 for c in cos.values()), f"{cfg.name} grad parity: cosines {cos}")
    emit(phase="grad_parity", arch=cfg.name, layers=cfg.num_layers, batch=1, seq_len=S,
         window=cfg.swa_window, grads_on_host=host, loss_bf16=lb, loss_f32=lf,
         loss_rel_diff=rel, min_cosine=min(cos.values()), min_cosine_plain_bf16=cos_plain,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, cosine=cos)
    del params, gf, flat
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 5. parity at full width in f32
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
    logits are more than 100x the difference apart; near ties are counted;
    a VLM's with its vision prefix, an encoder-decoder's with its frames),
    and the last prefill logits against decode_step token by token (text;
    an encoder-decoder's decode state holds the cross K/V of the encoder
    output). An MoE
    model runs at a capacity factor of E / k, where no expert can receive
    more pairs than its capacity: a prefill may drop pairs and a decode
    step never does, and the kernels' rounding could move a drop."""
    from repro_torch.configs import replace
    from repro_torch.models import (Impl, decode_step, forward,
                                    init_decode_state, init_params)
    from repro_torch.models.model import encode
    from repro_torch.runtime.steps import make_prefill_step

    if cfg.moe:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=(
            cfg.moe.num_experts / cfg.moe.top_k)))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                         dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = model_batch(cfg, B, S, gen, dtype=torch.float32)
    toks = batch["tokens"]
    V = cfg.vocab_size
    lk, aux = forward(cfg, params, batch, impl=Impl(), dtype=torch.float32)
    lp, _ = forward(cfg, params, batch, dtype=torch.float32,
                    impl=Impl(attention="plain", decode_attention="plain",
                              ssd="plain"))
    check(not cfg.moe or aux["moe_drop_frac"].item() == 0.0,
          f"{cfg.name}: pairs dropped at capacity factor {cfg.moe and cfg.moe.capacity_factor}")
    lk, lp = lk[..., :V], lp[..., :V]
    kern_err = (lk - lp).abs().max().item()
    top2 = lp.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 100 * kern_err
    same = lk.argmax(-1) == lp.argmax(-1)
    check(bool(torch.isfinite(lk).all()) and bool(same[decided].all()),
          f"{cfg.name}: kernel and plain forwards disagree (max err {kern_err})")
    del lk, lp

    short = {"tokens": toks[:, :S_dec]}            # text: decode has no vision prefix
    kw = {}
    if cfg.enc_dec:
        short["frames"] = batch["frames"]
        with torch.no_grad():
            kw = dict(params=params, enc_out=encode(cfg, params, batch["frames"]))
    pre = make_prefill_step(cfg, Impl(), dtype=torch.float32)(params, short)[:, 0, :V]
    short = short["tokens"]
    st = init_decode_state(cfg, B, S_dec, dtype=torch.float32, device="cuda", **kw)
    for t in range(S_dec):
        lg, st = decode_step(cfg, params, st, short[:, t:t + 1], impl=Impl(),
                             dtype=torch.float32)
    dec = lg[:, 0, :V]
    dec_err = (pre - dec).abs().max().item()
    check(torch.equal(pre.argmax(-1), dec.argmax(-1)) and dec_err <= 1e-3,
          f"{cfg.name}: prefill and decode disagree (max err {dec_err})")
    emit(phase="parity_prefill", arch=cfg.name, layers=cfg.num_layers,
         dtype="float32", batch=B, prompt_len=S, window=cfg.swa_window,
         vision_tokens=cfg.vision_tokens or None, frames=cfg.enc_ctx or None,
         kernel_vs_plain_max_abs=kern_err,
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

    def launch_times(name, kernel, earlier, calls=20, it=200):
        """A one-launch kernel and the two-launch design it replaced: eager
        (``it`` calls), graph replay of ``calls`` calls, kernels per call
        (must be 1)."""
        kpc = kernels_per_call(kernel)
        check(kpc == 1, f"{name}: {kpc} kernels per call")
        return dict(earlier_ms=cuda_ms(earlier, it), graph_ms=graph_ms([kernel] * calls),
                    earlier_graph_ms=graph_ms([earlier] * calls), kernels_per_call=kpc,
                    earlier_kernels_per_call=kernels_per_call(earlier))

    def guard_times(n, calls):
        """guard_copy on n rows: eager, plain, copy_, and launch_times."""
        p = _u32(n, gen)
        want = _word(mg.guard_copy_plain(p, tag, 0)[1])
        dst = torch.empty_like(p)
        it = 200 if n < 4096 else 50
        return dict(ms=cuda_ms(lambda: mg.guard_copy_cuda(p, tag, want), it),
                    plain_ms=cuda_ms(lambda: mg.guard_copy_plain(p, tag, want),
                                     max(5, it // 10)),
                    library_ms=cuda_ms(lambda: dst.copy_(p), it),
                    **launch_times(f"guard_copy on {n} rows",
                                   lambda: mg.guard_copy_cuda(p, tag, want),
                                   lambda: mg._guard_copy_two_pass(p, tag, want), calls, it),
                    nbytes=2 * n * 512 + 12, ops=2 * n * 128)

    # guard_copy: a request / response payload is one 512-byte row
    one = guard_times(1, 20)
    big = guard_times((64 << 20) // 512, 4)
    bb, bby = bound(big.pop("nbytes"), big.pop("ops"), "f32")
    row("guard_copy", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:93",
        "(1, 128) uint32", one["ms"], one["plain_ms"], one["nbytes"], one["ops"],
        "f32", one["library_ms"], earlier_ms=one["earlier_ms"], graph_ms=one["graph_ms"],
        earlier_graph_ms=one["earlier_graph_ms"], kernels_per_call=one["kernels_per_call"],
        earlier_kernels_per_call=one["earlier_kernels_per_call"],
        at_64MiB=dict(big, bound_ms=bb, bound_by=bby))

    def cold_times(kernel, earlier, plain, inputs, nbytes, ops):
        """``kernel``, ``earlier`` and ``plain`` over 4 distinct 32 MiB
        inputs called in turn (each call finds its input cold in L2), eager
        and (``graph_ms``) two passes replayed from one CUDA graph; the
        first input's result against the plain version."""
        check(_same(kernel(*inputs[0]), plain(*inputs[0])),
              f"{kernel.__name__} at 32 MiB differs from plain")
        b, by = bound(nbytes, ops, "f32")
        turn = [lambda x=x: kernel(*x) for x in inputs] * 2
        earlier_turn = [lambda x=x: earlier(*x) for x in inputs] * 2
        return dict(ms=cold_ms(kernel, inputs, 20), earlier_ms=cold_ms(earlier, inputs, 20),
                    graph_ms=graph_ms(turn), earlier_graph_ms=graph_ms(earlier_turn),
                    plain_ms=cold_ms(plain, inputs, 1), bound_ms=b, bound_by=by)

    def copyplane_times(one, two, plain, args, nbytes, ops):
        """The legacy copy plane's two-launch MAC against the one-launch
        kernel at a copyplane phase's shape."""
        check(_same(two(*args), plain(*args)) and _same(one(*args), plain(*args)),
              f"{two.__name__} at the copyplane shape differs from plain")
        b, by = bound(nbytes, ops, "f32")
        return dict(ms=cuda_ms(lambda: two(*args), 100),
                    one_launch_ms=cuda_ms(lambda: one(*args), 100),
                    plain_ms=cuda_ms(lambda: plain(*args), 5), bound_ms=b, bound_by=by)

    # mac_batch: the batch envelope's 8 one-row frames
    st = _stack(8, 1, gen)
    check(_same(mg.mac_batch_cuda(st, tag), mg.mac_batch_plain(st, tag)),
          "mac_batch at the envelope's shape differs from plain")
    stacks = [(_stack(64, 1024, gen), tag) for _ in range(4)]
    batch_plain_ms = cuda_ms(lambda: mg.mac_batch_plain(st, tag), 20)
    row("mac_batch", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:153",
        "(8, 1, 128) uint32", cuda_ms(lambda: mg.mac_batch_cuda(st, tag), 200),
        batch_plain_ms, 8 * 512 + 32,
        2 * 8 * 128, "f32", None,
        **launch_times("mac_batch", lambda: mg.mac_batch_cuda(st, tag),
                       lambda: mg._mac_batch_two_pass(st, tag)),
        at_32MiB=dict(shape="4 distinct (64, 1024, 128) uint32 stacks in turn, cold in L2",
                      **cold_times(mg.mac_batch_cuda, mg._mac_batch_two_pass,
                                   mg.mac_batch_plain, stacks, 64 * 1024 * 512 + 64 * 4,
                                   2 * 64 * 1024 * 128)))
    del stacks
    # the legacy copy plane's mac_batch (the two-launch design): the same
    # envelope shape, and the copyplane's 4 frames of a 1 MiB payload
    big_st = _stack(4, 2048, gen)
    row("mac_batch_two_pass", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:153",
        "(8, 1, 128) uint32", cuda_ms(lambda: mg._mac_batch_two_pass(st, tag), 200),
        batch_plain_ms, 8 * 512 + 32, 2 * 8 * 128, "f32", None,
        plane="legacy copy plane (framing.ZERO_COPY = False)",
        at_copyplane_1MiB_k4=dict(shape="(4, 2048, 128) uint32", **copyplane_times(
            mg.mac_batch_cuda, mg._mac_batch_two_pass, mg.mac_batch_plain,
            (big_st, tag), 4 * 2048 * 512 + 16, 2 * 4 * 2048 * 128)))
    del big_st

    # the streaming seal of a one-row frame: init, update, finalize
    h = mg.mac_init_state_cuda(tag, "cuda")
    blk = _u32(1, gen)
    row("mac_init_state", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:203",
        "(128,) uint32", cuda_ms(lambda: mg.mac_init_state_cuda(tag, "cuda"), 200),
        cuda_ms(lambda: mg.mac_init_state_plain(tag, "cuda"), 50), 512, 128,
        "f32", cuda_ms(lambda: torch.full((128,), 7, dtype=torch.int32,
                                           device="cuda"), 200))
    blocks = [(h, _u32(65536, gen)) for _ in range(4)]
    update_plain_ms = cuda_ms(lambda: mg.mac_update_plain(h, blk), 50)
    row("mac_update", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:241",
        "(1, 128) uint32 block", cuda_ms(lambda: mg.mac_update_cuda(h, blk), 200),
        update_plain_ms, 3 * 512, 2 * 128,
        "f32", None,
        **launch_times("mac_update", lambda: mg.mac_update_cuda(h, blk),
                       lambda: mg._mac_update_two_pass(h, blk)),
        at_65536_rows=dict(shape="4 distinct (65536, 128) uint32 blocks in turn, cold in L2",
                           **cold_times(mg.mac_update_cuda, mg._mac_update_two_pass,
                                        mg.mac_update_plain, blocks, 65536 * 512 + 2 * 512,
                                        2 * 65536 * 128)))
    del blocks
    # the legacy copy plane's mac_update (the two-launch design): a one-row
    # block, and the copyplane's 1 MiB payload (2048 rows, one block)
    big_blk = _u32(2048, gen)
    row("mac_update_two_pass", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:241",
        "(1, 128) uint32 block", cuda_ms(lambda: mg._mac_update_two_pass(h, blk), 200),
        update_plain_ms, 3 * 512, 2 * 128, "f32", None,
        plane="legacy copy plane (framing.ZERO_COPY = False)",
        at_copyplane_1MiB=dict(shape="(2048, 128) uint32 block", **copyplane_times(
            mg.mac_update_cuda, mg._mac_update_two_pass, mg.mac_update_plain,
            (h, big_blk), 2048 * 512 + 2 * 512, 2 * 2048 * 128)))
    del big_blk
    row("mac_finalize", "mpk_guard.cu", "src/repro/kernels/mpk_guard.py:271",
        "(128,) uint32", cuda_ms(lambda: mg.mac_finalize_cuda(h), 200),
        cuda_ms(lambda: mg.mac_finalize_plain(h), 50), 516, 2 * 128, "f32", None)

    # decode attention on the serving run's layer-0 cache and positions
    k, v, pos = attn_inputs
    B, S, Hkv, Dh = k.shape
    H = cfg.num_heads
    q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(k.dtype)
    qp = pos.to(torch.int32)[:, None]
    kp = kvcache.dense_cache_positions_rows({"k": k}, pos + 1)
    valid = int((kp >= 0).sum())
    cost = da.cost(q, k, kp, rows=valid)
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
        cost["bytes"], cost["flops"], "bf16", sdpa_ms([(q, k, v, kp)], 200),
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
        at_qwen3_cache=decode_at(gen, B, 1024, 40, 8, 128, layers=40),
        at_long_cache=decode_at(gen, B, 16384, H, Hkv, Dh, layers=1),
        at_whisper_cross_cache=decode_at(gen, 8, 1500, 6, 6, 64, layers=4, causal=False),
        at_llava_ring=decode_at(gen, 8, 4096, 32, 8, 128, layers=32, window=4096,
                                ring=True))
    del q, k, v, attn_inputs
    torch.cuda.empty_cache()
    rows.append(flash_row(gen, launches, err))
    rows.append(flash_bwd_row(gen, launches, err))
    rows.append(ssd_row(gen, launches, err))
    rows.append(ssd_bwd_row(gen, launches, err))
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


def cold_ms(fn, inputs, iters):
    """ms per call of ``fn`` over ``inputs`` (argument tuples) called in
    turn, ``iters`` passes (CUDA events)."""
    calls = [lambda x=x: fn(*x) for x in inputs]
    return cuda_ms(lambda: [c() for c in calls], iters) / len(calls)


def decode_at(gen, B, S, H, Hkv, Dh, layers, causal=True, window=None, ring=False):
    """Decode attention over ``layers`` distinct (B, S, Hkv, Dh) bf16 caches
    with every row valid, called in turn as a decode tick calls its layers:
    with 16 layers of (8, 1024, 8, 64) (268 MB), 40 of (8, 1024, 8, 128)
    (1.34 GB, qwen3-14b's), one (8, 16384, 8, 64) cache (268 MB), whisper's
    4 cross caches of (8, 1500, 6, 64) (non-causal) or llava's 32 full
    rings of (8, 4096, 8, 128) (4.3 GB; positions rotated through the slots
    as a wrapped ring holds them, every one inside the window) each call
    finds its cache cold in L2 (whisper's 74 MB only partly). Eager, graph
    replay (one capture of a pass over the layers), the earlier design,
    SDPA, the byte bound; the first layer against the plain version
    (2e-2)."""
    from repro_torch.kernels import decode_attention as da
    q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    caches = [tuple(torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda")
                    .to(torch.bfloat16) for _ in range(2)) for _ in range(layers)]
    ar = torch.arange(S, device="cuda")
    if ring:
        kp = ((ar + 7 * S // 10) % S + 5000).to(torch.int32)[None].repeat(B, 1)
        qp = torch.full((B, 1), 5000 + S - 1, dtype=torch.int32, device="cuda")
    else:
        kp = ar.to(torch.int32)[None].repeat(B, 1)
        qp = torch.full((B, 1), S - 1, dtype=torch.int32, device="cuda")
    mode = dict(causal=causal, window=window)
    k0, v0 = caches[0]
    e = (da.decode_attention_cuda(q, k0, v0, qp, kp, **mode).float()
         - da.decode_attention_plain(q, k0, v0, qp, kp, **mode).float()).abs().max().item()
    check(e <= 2e-2, f"decode_attention at ({B}, {S}), causal {causal}, window "
          f"{window}, ring {ring}: max err {e}")
    calls = [lambda k=k, v=v: da.decode_attention_cuda(q, k, v, qp, kp, **mode)
             for k, v in caches]
    earlier = [lambda k=k, v=v: da._decode_attention_split_merge(q, k, v, qp, kp, **mode)
               for k, v in caches]
    per_pass = max(1, 32 // layers)      # 2 passes over 16 layers, 1 over 40, or 32 calls
    calls, earlier = calls * per_pass, earlier * per_pass
    cost = da.cost(q, k0, kp)
    b_ms, by = bound(cost["bytes"], cost["flops"], "bf16")
    what = ("causal" if causal else "non-causal") + (f", window {window}" if window else "") \
        + (", ring positions" if ring else "")
    out = dict(shape=f"q ({B}, 1, {H}, {Dh}) bf16 over {layers} x ({B}, {S}, {Hkv}, {Dh})"
                     f" bf16 caches, every row valid, {what}, in turn",
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
    cost = fa.cost(q, k, pairs=pairs)
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), 20)
    kpc = kernels_per_call(lambda: fa.flash_attention_cuda(q, k, v, qp, kp))
    check(kpc == 1, f"flash_attention: {kpc} kernels per call")
    row = _row("flash_attention", "flash_attention.cu",
                "src/repro/kernels/flash_attention.py:76", launches, err,
                f"q ({B}, {S}, {H}, {Dh}) bf16 over k/v ({B}, {S}, {Hkv}, {Dh}), "
                f"causal", cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, qp, kp),
                                   20),
                cuda_ms(lambda: fa.flash_attention_plain(q, k, v, qp, kp), 2),
                cost["bytes"], cost["flops"], "bf16", lib, valid_pairs=pairs,
                earlier_ms=cuda_ms(lambda: fa._flash_attention_cuda_cores(
                    q, k, v, qp, kp), 5),
                kernels_per_call=kpc,
                tensor_core_instr=tensor_core_instr("flash_attention",
                                                    ("flash_fwd_wgmma",)))
    del q, k, v, qs, ks, vs
    row["at_dh80"] = flash_at(gen, 4, 2048, 32, 32, 80)
    row["at_qwen3"] = flash_at(gen, 4, 2048, 40, 8, 128)
    row["at_mixtral"] = flash_at(gen, 2, 6144, 32, 8, 128, window=4096)
    row["at_grok"] = flash_at(gen, 4, 2048, 48, 8, 128)
    row["at_whisper_enc"] = flash_at(gen, 8, 1500, 6, 6, 64, causal=False)
    row["at_whisper_cross"] = flash_at(gen, 8, 1500, 6, 6, 64, Sq=448, causal=False)
    return row


def flash_at(gen, B, S, H, Hkv, Dh, window=None, Sq=None, causal=True):
    """The forward over B rows of ``Sq`` queries (default S) at the last
    positions of S keys, H query heads over Hkv kv heads of Dh, causal
    (within ``window`` if given) or not, bf16: zamba2-2.7b's attention
    (Dh 80, MHA), qwen3-14b's prefill, grok-1-314b's (48/8 heads of 128,
    g 6), mixtral-8x7b's past its window,
    whisper-tiny's encoder (non-causal) and cross-attention (448 queries
    over 1500 frames). ms, plain ms, the bound from this run's valid pairs,
    SDPA (``is_causal``, no mask when non-causal, or the same pairs as a
    boolean mask) and the error against the plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    Sq = Sq or S
    q, k, v, qp, kp = flash_inputs(gen, B, Sq, S, H, Hkv, Dh, torch.bfloat16, tail=0)
    ok = (kp[:, None, :] >= 0) & (qp[:, :, None] >= 0)        # (B, Sq, S)
    if causal:
        ok = ok & (kp[:, None, :] <= qp[:, :, None])
    if window is not None:
        ok &= (qp[:, :, None] - kp[:, None, :]) < window
    pairs = int(ok.sum())
    args = dict(causal=causal, window=window)
    e = (fa.flash_attention_cuda(q, k, v, qp, kp, **args).float()
         - fa.flash_attention_plain(q, k, v, qp, kp, **args).float()).abs().max().item()
    check(e <= 2e-2, f"flash_attention at ({B}, {Sq} over {S}, {H}/{Hkv}, {Dh}), "
          f"causal {causal}, window {window}: max err {e}")
    cost = fa.cost(q, k, pairs=pairs)
    b_ms, by = bound(cost["bytes"], cost["flops"], "bf16")
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = ok[:, None] if window is not None else None

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              is_causal=causal and mask is None,
                                              enable_gqa=H != Hkv)
    what = "causal" if causal else "non-causal"
    return dict(shape=f"q ({B}, {Sq}, {H}, {Dh}) bf16 over k/v ({B}, {S}, {Hkv}, {Dh}), "
                      f"{what}" + (f", window {window}" if window else ""),
                ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, qp, kp, **args), 20),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, qp, kp,
                                                                  **args), 2),
                bound_ms=b_ms, bound_by=by, valid_pairs=pairs, max_abs_err=e,
                library_ms=cuda_ms(library, 20))


FLASH_BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma")


def flash_bwd_case(gen, B, S, H, Hkv, Dh, Sq=None, causal=True, window=None):
    """bf16 inputs of the backward at (B, Sq over S, H/Hkv, Dh), causal or
    not (within ``window`` if given), the forward kernel's output and
    log-sum-exp, a random dO; the valid pairs, the bound's bytes and SDPA's
    backward on the same q, k, v and dO (its forward outside the timing;
    with a window, the same pairs as a boolean mask)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    Sq = Sq or S
    q, k, v, qp, kp = flash_inputs(gen, B, Sq, S, H, Hkv, Dh, torch.bfloat16, tail=0)
    out, lse = fa.flash_attention_cuda(q, k, v, qp, kp, causal=causal, window=window,
                                       return_lse=True)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, k, v, out, lse, dout, qp, kp)
    ok = (kp[:, None, :] >= 0) & (qp[:, :, None] >= 0)        # (B, Sq, S)
    if causal:
        ok = ok & (kp[:, None, :] <= qp[:, :, None])
    if window is not None:
        ok &= (qp[:, :, None] - kp[:, None, :]) < window
    pairs = int(ok.sum())
    cost = fa.cost_bwd(q, k, pairs=pairs)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    mask = ok[:, None] if window is not None else None
    ref = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         is_causal=causal and mask is None,
                                         enable_gqa=H != Hkv)
    douts = dout.transpose(1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(ref, (qs, ks, vs), douts, retain_graph=True),
                  20)
    return args, pairs, cost, lib


def flash_bwd_row(gen, launches, err):
    """The attention backward at llama3.2-1b's training shape: a microbatch
    of 2 x 2048 tokens, 32 query heads over 8 kv heads of 64, causal, bf16.
    The operations are the five products, 10·Dh·H per valid (q, kv) pair of
    this run's positions; the bytes read q, k, v, o, dO, lse and the
    positions once and write dq, dk, dv once. ``library_ms`` is the
    backward of PyTorch's scaled_dot_product_attention (causal, GQA) on
    the same inputs, its forward outside the timing. ``earlier_ms`` is the
    mma.sync design timed here on the same inputs, ``pass_ms`` each of the
    three launches' device time (torch.profiler), ``at_dh80`` the same at
    zamba2-2.7b's attention (1, 2048, 32, 80), MHA."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, Hkv, Dh = 2, 2048, 32, 8, 64
    args, pairs, cost, lib = flash_bwd_case(gen, B, S, H, Hkv, Dh)
    kpc = kernels_per_call(lambda: fa.flash_attention_bwd_cuda(*args))
    check(kpc == 3, f"flash_attention_bwd: {kpc} kernels per call, want 3 "
          f"(delta, dK/dV, dQ)")
    row = _row("flash_attention_bwd", "flash_attention_bwd.cu",
               "src/repro/kernels/flash_jnp.py:113 (_flash_bwd, no pallas_call)",
               launches, err,
               f"q ({B}, {S}, {H}, {Dh}) bf16 over k/v ({B}, {S}, {Hkv}, {Dh}), "
               f"causal, dO, lse", cuda_ms(lambda: fa.flash_attention_bwd_cuda(*args), 20),
               cuda_ms(lambda: fa.flash_attention_bwd_plain(*args), 2),
               cost["bytes"], cost["flops"], "bf16", lib, valid_pairs=pairs,
               earlier_ms=cuda_ms(lambda: fa._flash_attention_bwd_mma_sync(*args), 10),
               pass_ms=short_names(kernel_ms(lambda: fa.flash_attention_bwd_cuda(*args)),
                                   FLASH_BWD_KERNELS),
               kernels_per_call=kpc,
               tensor_core_instr=tensor_core_instr("flash_attention_bwd",
                                                   FLASH_BWD_KERNELS[1:]))
    check(row["tensor_core_instr"] > 0, "flash_attention_bwd: no HGMMA in its kernels")
    del args
    row["at_dh80"] = flash_bwd_at(gen, 1, 2048, 32, 32, 80)
    row["at_olmo"] = flash_bwd_at(gen, 2, 2048, 16, 16, 128)
    row["at_qwen3"] = flash_bwd_at(gen, 2, 2048, 40, 8, 128)
    row["at_mixtral"] = flash_bwd_at(gen, 1, 6144, 32, 8, 128, window=4096)
    row["at_grok"] = flash_bwd_at(gen, 2, 2048, 48, 8, 128)
    row["at_whisper_cross"] = flash_bwd_at(gen, 2, 1500, 6, 6, 64, Sq=448, causal=False)
    return row


def flash_bwd_at(gen, B, S, H, Hkv, Dh, Sq=None, causal=True, window=None):
    """The backward at another training shape, bf16: zamba2-2.7b's
    attention (Dh 80, 32 heads, MHA, its microbatch of 1 x 2048), olmo-1b's
    (Dh 128, 16 heads, MHA, 2 x 2048), qwen3-14b's (2 x 2048, 40/8 heads of
    128, g 5), grok-1-314b's (2 x 2048, 48/8 of 128, g 6), all causal;
    mixtral-8x7b's and llava's (1 x 6144, 32/8 of 128) with the window of
    4096 binding; whisper-tiny's cross-attention (448 queries over 1500
    frames, 6 heads of 64, its microbatch of 2), non-causal. ms, earlier
    ms, pass ms, bound, SDPA's backward and the error against the plain
    version."""
    from repro_torch.kernels import flash_attention as fa
    Sq = Sq or S
    args, pairs, cost, lib = flash_bwd_case(gen, B, S, H, Hkv, Dh, Sq, causal, window)
    mode = dict(causal=causal, window=window)
    got = fa.flash_attention_bwd_cuda(*args, **mode)
    want = fa.flash_attention_bwd_plain(*args, **mode)
    e = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    excess = max(((g.float() - w.float()).abs() - 2e-2 * (1 + w.float().abs())).max().item()
                 for g, w in zip(got, want))
    check(excess <= 0, f"flash_attention_bwd at ({B}, {Sq} over {S}, {H}/{Hkv}, {Dh}), "
          f"causal {causal}, window {window}: over tolerance by {excess}")
    b_ms, by = bound(cost["bytes"], cost["flops"], "bf16")
    what = ("causal" if causal else "non-causal") + (f", window {window}" if window else "")
    return dict(shape=f"q ({B}, {Sq}, {H}, {Dh}) bf16 over k/v ({B}, {S}, {Hkv}, {Dh}), "
                      f"{what}, dO, lse", valid_pairs=pairs,
                ms=cuda_ms(lambda: fa.flash_attention_bwd_cuda(*args, **mode), 20),
                earlier_ms=cuda_ms(lambda: fa._flash_attention_bwd_mma_sync(
                    *args, **mode), 10),
                pass_ms=short_names(kernel_ms(lambda: fa.flash_attention_bwd_cuda(
                    *args, **mode)), FLASH_BWD_KERNELS),
                plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(*args, **mode), 2),
                bound_ms=b_ms, bound_by=by, max_abs_err=e, library_ms=lib)


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
    cost = ss.cost(x, dt, Bm, chunk=Q)
    _, passes = ss.bf16_launches(x, dt, A_log, Bm, Cm, D, chunk=Q)
    kpc = kernels_per_call(lambda: ss.ssd_scan_cuda(x, dt, A_log, Bm, Cm, D, chunk=Q))
    check(kpc == len(passes),
          f"ssd_scan: {kpc} kernels per call, want {len(passes)}")
    return _row("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:70",
                launches, err,
                f"x ({B}, {S}, {H}, {P}) bf16, B/C ({B}, {S}, {G}, {N}), chunk {Q}",
                cuda_ms(lambda: ss.ssd_scan_cuda(x, dt, A_log, Bm, Cm, D, chunk=Q),
                        20),
                cuda_ms(lambda: ss.ssd_scan_plain(x, dt, A_log, Bm, Cm, D,
                                                  chunk=Q), 2),
                cost["bytes"], cost["flops"], "bf16", None,
                earlier_ms=cuda_ms(lambda: ss._ssd_scan_cuda_cores(
                    x, dt, A_log, Bm, Cm, D, chunk=Q), 5),
                kernels_per_call=kpc,
                pass_ms={name: cuda_ms(run, 20) for name, run in passes},
                tensor_core_instr=tensor_core_instr(
                    "ssd_scan", ("ssd_states_mma", "ssd_output_mma")))


def ssd_bwd_row(gen, launches, err):
    """The SSD backward at mamba2-1.3b's training microbatch: dy over x
    (2, 2048, 64, 64) bf16, B/C (2, 2048, 1, 128), chunk 128, no init state
    and no final-state gradient (the training path). The operations are the
    chunked form's products that the gradients need once each: per chunk
    and head C·Bᵀ, dy·xᵀ and the three intra products over the Q(Q+1)/2
    causal pairs, and five Q·N·P products (the recomputed chunk states, the
    chunks' Σ exp(cum)·dy ⊗ C, and the carry and inter terms of dx, dB,
    dC); the bytes read x, dt, B, C, dy, A_log and D once and write dx, ddt,
    dB, dC, dA_log and dD once. A call is six kernels, each also timed
    alone (``pass_ms``); ``earlier_ms`` and ``earlier_pass_ms`` are the
    same with the earlier per-head chunk kernel. No single PyTorch call
    computes it."""
    from repro_torch.kernels import ssd_scan as ss
    B, S, H, P, G, N, Q = 2, 2048, 64, 64, 1, 128, 128
    x, dt, A_log, Bm, Cm, D = ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
    args = (x, dt, A_log, Bm, Cm, D, None, dy, None)
    cost = ss.cost_bwd(x, dt, Bm, chunk=Q)
    _, passes = ss.bwd_launches(*args, chunk=Q)
    _, earlier = ss.bwd_launches(*args, chunk=Q, per_head=True)
    kpc = kernels_per_call(lambda: ss.ssd_scan_bwd_cuda(*args, chunk=Q))
    check(kpc == len(passes),
          f"ssd_scan_bwd: {kpc} kernels per call, want {len(passes)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return _row("ssd_scan_bwd", "ssd_scan.cu",
                "src/repro/kernels/ssd_jnp.py:31 (autodiff of ssd_chunked, no pallas_call)",
                launches, err,
                f"dy over x ({B}, {S}, {H}, {P}) bf16, B/C ({B}, {S}, {G}, {N}), chunk {Q}",
                cuda_ms(lambda: ss.ssd_scan_bwd_cuda(*args, chunk=Q), 20),
                cuda_ms(lambda: ss.ssd_scan_bwd_plain(*args, chunk=Q), 2),
                cost["bytes"], cost["flops"], "bf16", None, kernels_per_call=kpc,
                heads_per_tile=ss.bwd_heads_per_tile(B, S, H, G, Q, sms),
                earlier_ms=cuda_ms(lambda: ss._ssd_scan_bwd_per_head(*args, chunk=Q), 20),
                pass_ms={name: cuda_ms(run, 20) for name, run in passes},
                earlier_pass_ms={name: cuda_ms(run, 20) for name, run in earlier},
                tensor_core_instr=tensor_core_instr(
                    "ssd_scan", ("ssd_bwd_tile_mma", "ssd_states_mma")))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        sys.exit(2)
    from repro_torch.configs import get_config, replace
    from repro_torch.device import resolve
    from repro_torch.launch.dryrun import TRAIN_OPT_DTYPE, TRAIN_PARAM_DTYPE
    resolve("cuda")                          # TF32 off for the f32 phase

    t0 = time.perf_counter()
    smi = phase_card()
    err = phase_kernels()
    launches = {}                            # summed over the main-path runs

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    add(phase_fabric(smi))
    llama, mamba, zamba, olmo, smollm, qwen3 = (get_config(a) for a in (
        "llama3.2-1b", "mamba2-1.3b", "zamba2-2.7b", "olmo-1b", "smollm-360m",
        "qwen3-14b"))
    mixtral = replace(get_config("mixtral-8x7b"), num_layers=MIXTRAL_LAYERS)
    whisper, llava = get_config("whisper-tiny"), get_config("llava-next-mistral-7b")
    grok = replace(get_config("grok-1-314b"), num_layers=GROK_SERVE_LAYERS)
    add(phase_ipc(smi))
    for cfg in (llama, mamba, zamba, olmo, smollm, qwen3):
        add(phase_prefill(cfg))
    add(phase_prefill(mixtral, B=2, S=6144))
    add(phase_prefill(llava, B=2, S=6144))
    add(phase_prefill(grok))
    add(phase_prefill(whisper, B=8, S=WHISPER_TEXT))
    add(phase_padded(smollm, SMOLLM_PADS))
    counts, attn_inputs = phase_serve(llama, sessions=True)
    add(counts)
    add(phase_gateway(llama, smi))
    add(phase_copyplane(smi))
    add(phase_examples(smi))
    add(phase_proc(llama, smi))
    for cfg in (mamba, zamba, olmo, smollm, qwen3, mixtral, llava, grok):
        add(phase_serve(cfg, n_clients=8)[0])
    add(phase_decode(whisper, B=8, max_seq=WHISPER_TEXT))
    add(phase_decode(llava, B=8, max_seq=32768))
    add(phase_ring_parity(replace(llava, num_layers=2)))
    add(phase_train(llama)[0])
    add(phase_train(mamba)[0])
    counts, zamba_peak = phase_train(zamba, micro=ZAMBA_MICRO)
    add(counts)
    add(phase_train(olmo)[0])
    add(phase_train(smollm)[0])
    add(phase_train(whisper, seq=WHISPER_TEXT)[0])
    add(phase_train(replace(qwen3, num_layers=QWEN3_TRAIN_LAYERS), steps=4,
                    published=qwen3)[0])
    add(phase_train(replace(mixtral, num_layers=MIXTRAL_TRAIN_LAYERS), steps=4,
                    batch=2, seq=6144, micro=1, remat=True,
                    published=get_config("mixtral-8x7b"))[0])
    add(phase_train(replace(llava, num_layers=LLAVA_TRAIN_LAYERS), steps=4,
                    batch=2, seq=6144, micro=1, remat=True, published=llava)[0])
    add(phase_train(replace(grok, num_layers=GROK_TRAIN_LAYERS), steps=4, batch=2,
                    param_dtype=TRAIN_PARAM_DTYPE["grok-1-314b"],
                    opt_dtype=TRAIN_OPT_DTYPE["grok-1-314b"], remat=True,
                    published=get_config("grok-1-314b"))[0])
    add(phase_remat(llama))
    add(phase_remat(replace(mixtral, num_layers=MIXTRAL_TRAIN_LAYERS), batch=1,
                    seq=4224, micro=1, peak_drops=False))
    add(phase_train(zamba, steps=2, micro=2, remat=True, beside=dict(
        peak_mem_gb_micro1_no_remat=zamba_peak))[0])
    kernels = kernels_line(llama, launches, err, attn_inputs)
    idle = [r["name"] for r in kernels if not r["launches"]]
    check(not idle, f"kernels the main paths never launched: {idle}")
    del attn_inputs
    torch.cuda.empty_cache()
    phase_grad_parity(llama)
    phase_grad_parity(mamba)
    phase_grad_parity(olmo)
    phase_grad_parity(whisper, S=WHISPER_TEXT)
    phase_grad_parity(replace(qwen3, num_layers=2))
    phase_grad_parity(replace(mixtral, num_layers=2), S=4224)
    phase_grad_parity(replace(grok, num_layers=1), host=True)
    phase_parity(llama)
    for cfg in (llama, mamba, zamba, whisper):
        phase_prefill_parity(cfg)
    for cfg in (olmo, smollm, qwen3):
        phase_prefill_parity(replace(cfg, num_layers=2))
    phase_prefill_parity(replace(mixtral, num_layers=2), B=1, S=4224)
    phase_prefill_parity(replace(llava, num_layers=2), B=1, S=4224)
    phase_prefill_parity(replace(grok, num_layers=1))
    emit(phase="done", wall_s=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
