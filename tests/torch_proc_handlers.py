"""Module-level service handlers for the port's process-transport tests.

A process transport sends its handler to a child process started by a
forkserver, so a handler must pickle: the reference tests' closures and
lambdas become the functions here (and ``functools.partial`` of them).
This module imports numpy, torch and the port only, so a child that
unpickles a handler does not import JAX."""
import time

import numpy as np
import torch

from repro_torch.core.transports import HandlerCrash
from repro_torch.core.wordcount import wordcount_handler


def host(req) -> np.ndarray:
    """A request (a tensor on any device, or an array) as host bytes."""
    if isinstance(req, torch.Tensor):
        return req.detach().contiguous().reshape(-1).view(torch.uint8) \
            .cpu().numpy()
    return np.ascontiguousarray(req).reshape(-1).view(np.uint8)


def echo(req):
    return host(req)[::-1].copy()


def echo_same(req):
    return host(req).copy()


def grow(req):
    return np.zeros(256 * 1024, np.uint8)


def angry(req):
    raise ValueError("wrong shape")


def slow(req, sleep_s=1.0):
    time.sleep(sleep_s)
    return host(req).copy()


def die(req):
    raise HandlerCrash("chaos")


def die_second(req):
    if host(req)[0] == 2:
        raise HandlerCrash("mid-drain death")
    return host(req).copy()


def tagged(i, req):
    """Appends replica index ``i`` to the payload: the child-side identity
    that proves where a request ran (``functools.partial(tagged, i)``)."""
    return np.concatenate([host(req), np.array([i], np.uint8)])


def slow_tagged(i, req, sleep_s=0.004):
    time.sleep(sleep_s)
    return tagged(i, req)


def flaky(req):
    raise HandlerCrash("die")


def wordcount(req):
    return wordcount_handler(req)


def wordcount_factory():
    return wordcount_handler


# ---------------------------------------------------------------------------
# the proc test modules' hygiene check and time bound
# ---------------------------------------------------------------------------

def proc_hygiene(module_name: str, settle: float = 10.0):
    """After a proc test module: this process owns no unreaped child, no
    ``/dev/shm/mpk_<pid>_*`` segment, no open doorbell fd (the port's
    ledger, ``procwire.open_doorbell_fds``) and no session still holding
    the slab it shares with a child (``procwire.open_slabs``). Teardowns
    that are still settling get ``settle`` seconds; then the module
    fails, named."""
    import gc
    import multiprocessing
    import os

    import pytest

    from repro_torch.core import procwire

    gc.collect()
    mine = f"mpk_{os.getpid()}_"
    deadline = time.monotonic() + settle
    while True:
        procwire._sweep_deferred_closes()
        kids = multiprocessing.active_children()
        segs = ([f for f in os.listdir("/dev/shm") if f.startswith(mine)]
                if os.path.isdir("/dev/shm") else [])
        bells = procwire.open_doorbell_fds()
        slabs = procwire.open_slabs()
        if not kids and not segs and not bells and not slabs:
            return
        if time.monotonic() > deadline:
            pytest.fail(
                f"proc hygiene ({module_name}): unreaped children="
                f"{[k.pid for k in kids]} leaked shm segments={segs} open "
                f"doorbell fds={bells} sessions holding a slab={slabs}")
        gc.collect()
        time.sleep(0.05)


class bounded:
    """A hard wall-clock bound on one test (pytest has no timeout plugin
    here): past ``seconds`` every thread's stack is dumped and the process
    exits, so a hang fails its test instead of stalling the run."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def __enter__(self):
        import faulthandler
        faulthandler.dump_traceback_later(self.seconds, exit=True)
        return self

    def __exit__(self, *exc):
        import faulthandler
        faulthandler.cancel_dump_traceback_later()
        return False
