"""Start a world of ranks, one process each, and collect what they return.

    results = run_world(fn, 4, *args, device="cuda")

Each rank is a process started from the forkserver (CUDA does not survive
``fork``; the port never forks). It joins a gloo process group through a
``FileStore`` in a fresh temporary directory (no TCP port to collide
with), with a timeout, so that a lost peer fails its collectives instead
of hanging them. Then it calls ``fn(rank, world_size, *args)`` and hands
back the result, with every tensor in it moved to the host as a numpy
array (bf16 as f32). ``fn`` must pickle: a module-level function.

On the card every rank computes on the same device (``cuda:0``): a host
with one card cannot run NCCL between ranks, so the exchanges go over gloo
and the fabric stages them through pinned host buffers
(``core.fabric.FABRIC_STATS`` counts the bytes). A rank loads the kernel
libraries its parent built and never builds one: the parent builds them
first (``kernels._build.build()``).

If a rank raises, or the world outlives ``timeout``, every rank is
stopped and the error is raised here with the rank's traceback. When the
call returns, no rank process and no store file is left.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

_CTX = multiprocessing.get_context("forkserver")


def _host(obj: Any) -> Any:
    """Tensors → numpy arrays (bf16, which numpy lacks, as f32), through
    dicts, lists and tuples."""
    import torch
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _rank_main(fn, rank: int, world: int, store_path: str, device: str,
               init_timeout_s: float, out, args) -> None:
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.kernels import _build
        _build.ALLOW_BUILD = False
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=init_timeout_s))
        try:
            result = _host(fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except Exception:                    # hand the failure to the parent
        out.put((rank, False, traceback.format_exc()))


def run_world(fn: Callable, world_size: int, *args, device: str = "cuda",
              timeout: float = 300.0, init_timeout: float = 120.0,
              store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` rank processes
    → their results, by rank. ``device`` is the device the ranks compute
    on ("cuda": every rank on ``cuda:0``; tests pass "cpu");
    ``init_timeout`` bounds each collective of a rank, ``timeout`` the
    whole world. The store file lies in ``store_dir`` (default: a fresh
    temporary directory, removed afterwards) and is removed afterwards."""
    from repro_torch.device import resolve
    resolve(device)
    tmp = tempfile.mkdtemp(prefix="repro_world_") if store_dir is None else None
    store = os.path.join(store_dir or tmp, "store")
    out = _CTX.Queue()
    procs = [_CTX.Process(target=_rank_main, daemon=True,
                          args=(fn, r, world_size, store, device,
                                init_timeout, out, args))
             for r in range(world_size)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        grace = None                     # a result may trail its rank's exit
        while len(results) < world_size:
            try:
                rank, ok, value = out.get(
                    timeout=min(0.5, max(0.0, deadline - time.monotonic())))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    grace = grace or time.monotonic() + 5.0
                    if time.monotonic() > grace:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {world_size} ranks "
                                       f"outlived {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(30)
        return [results[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(10)
        out.close()
        out.join_thread()
        if tmp is None:
            if os.path.exists(store):
                os.unlink(store)
        else:
            shutil.rmtree(tmp, ignore_errors=True)
