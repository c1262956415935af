"""True inter-process MPKLink: each service in a process of its own over
POSIX shared memory, plus the paper's honest baselines (the port of
``repro.core.procwire``).

Five process-backed transports behind the same
:class:`~repro_torch.core.transports.Session` API:

  shm_proc          raw fixed-capacity shared memory, the service in a
                    child process, slots + control words in a POSIX segment
  mpklink_proc      the paper's MPKLink across a real process boundary:
                    per-chunk PKRU key-sync ping-pong through shared
                    control words, CA-enrolled per-session domains/seeds,
                    sealed frames verified in the child
  mpklink_opt_proc  one key sync per publish, the same protection envelope
  rest              a real loopback HTTP/1.1 REST server
                    (``ThreadingHTTPServer`` in a child, persistent
                    connections, one JSON ``POST`` a request)
  sockrpc           length-prefixed RPC over loopback TCP (the uds
                    transport's ``_LEN`` / ``_ERR_BIT`` wire protocol)

Process model:

* **Children are started by a forkserver**, on the CPU and on the card
  alike (``multiprocessing.get_context("forkserver")``, preloaded with this
  module, so torch is imported once and every child is a cheap fork of the
  server). CUDA does not survive ``fork``: the parent's own data plane runs
  the guard kernels, and the forkserver, started by fork + exec, never
  holds a CUDA context. A child is started lazily at the first exchange.
* **The snapshot is a pickle**, taken when the child starts: the service
  side of the session (the handler, the seed, the domain and key words)
  travels in the child's arguments, so whatever the parent configured by
  then (gateway channels, fault fabrics, swapped handlers) is in it.
  Control-plane changes made after the child started are not seen until a
  fresh session (``GatewayClient.heal``) starts a fresh child. A handler
  that does not pickle (a closure, a lambda) is refused in the parent with
  :class:`HandlerNotPicklable` before any child starts; nothing carries on
  in-process in its place. Locks in a snapshot arrive as fresh locks.
* **Segments** are created by the client (parent) as POSIX shared memory
  named ``mpkt_<pid>_<hex8>`` (:data:`SEGMENT_PREFIX`; the reference's
  segments are ``mpk_*``, so a sweep of either package's names never
  touches the other's); the parent is the owner and its ``close()``
  unlinks it (idempotently). The child receives the segment's file
  descriptor and maps it; it never attaches by name, so Python's resource
  tracker sees the segment once, from its owner.
* **Layout**: the control block (:data:`PROC_CTRL_WORDS` u32 words), a ring
  of :data:`PROC_SLOT_WORDS`-word slot headers and a flat ``(rows, 128)``
  u32 data slab carved by a client-owned :class:`framing.FrameArena`
  (``backing=`` the slab). On the CPU the slab follows the slot headers in
  the segment (the reference's layout). On the card it is an allocation of
  its own on the device, which reaches the child through CUDA IPC
  (``torch.multiprocessing``'s reductions), so every MAC runs where the
  frame lies. The client allocates both the request slot and a worst-case
  response slot a message and publishes their row offsets in the slot
  header; the child seals its response into that area.
* **Ordering across processes**: two processes share no stream, so a
  writer synchronizes its stream before it writes the slot-state word and
  rings (``stream_syncs`` counts the parent's). The parent recycles a slot
  only after it has read ``_DONE``.
* **Doorbells** are socketpairs (:class:`ProcDoorbell`); the parent closes
  its copies of the child's ends once the child has them, so the child's
  death is an EOF on the parent's read end: ``kill -9`` surfaces as a typed
  :class:`~repro_torch.core.transports.ServiceCrashed` within one poll.
* **Crash invariant**: once the child is dead, in-flight slots (and the
  arena slots behind them) are never recycled; the slab stays alive until
  the child is reaped and the session closed.
* **Kernels**: on the card the parent builds the kernel libraries
  (``kernels._build.build``) before its first child starts; a child loads
  them and never builds one. After each completed slot the child publishes
  its guard and decode kernel launch counts in the control block
  (:meth:`ProcSession.child_launches`).
"""
from __future__ import annotations

import atexit
import base64
import contextlib
import gc
import http.client
import io
import itertools
import json
import mmap
import multiprocessing
import os
import pickle
import select
import signal
import socket
import struct
import sys
import threading
import time
import traceback
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from multiprocessing import reduction
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import framing
from repro_torch.core.ca import enroll
from repro_torch.core.domains import READ, RW, WRITE, mac_seed
from repro_torch.core.transports import (CapacityError, DropResponse, Handler,
                                         HandlerCrash, MPKLinkTransport,
                                         ResponseTimeout, ServiceCrashed,
                                         Session, ShmTransport, Transport,
                                         TransportError, _ERR_BIT, _LEN,
                                         _from_host, _host, _on_stream,
                                         _pack_error, _raise_remote, _raw,
                                         _recv_exact)
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# wire constants (the reference's values)
# ---------------------------------------------------------------------------

PROC_MAGIC = 0x4D504B50         # "MPKP": process-backed segment marker
PROC_VERSION = 1
PROC_CTRL_WORDS = 32            # control block size (u32 words)
PROC_SLOT_WORDS = 16            # per-slot header size (u32 words)
SEGMENT_PREFIX = "mpkt_"        # the port's segments: mpkt_<pid>_<hex8>

# control-block word indices
_W_MAGIC, _W_VERSION, _W_STOP, _W_SYNC_SEQ, _W_SYNC_ACK, _W_PKRU_LO, \
    _W_PKRU_HI, _W_EPOCH, _W_SVC_SYNC, _W_HEAD, _W_MODE = range(11)
# words the reference leaves unused: the child's "ready" flag (set once it
# has loaded its snapshot and reached its device) and its kernel launch
# counts, one word a kernel of ops.KERNELS
_W_READY = 11
_W_LAUNCH0 = 16

# per-slot header word indices
_S_STATE, _S_TICKET, _S_REQ_OFF, _S_REQ_ROWS, _S_REQ_NBYTES, _S_RESP_OFF, \
    _S_RESP_CAP, _S_RESP_ROWS, _S_RESP_NBYTES, _S_ERR, _S_SEQ = range(11)

# slot states — same enum as the in-process ring
_FREE, _STAGED, _PUBLISHED, _DONE, _DROPPED = range(5)

_MODE_SHM, _MODE_MPKLINK = 0, 1
_ERR_OK, _ERR_BLOB = 0, 1       # _S_ERR: 0 = sealed response, 1 = error blob

_U32 = 0xFFFFFFFF
_ROW_BYTES = framing.LANES * 4

assert _W_LAUNCH0 + len(ops.KERNELS) <= PROC_CTRL_WORDS

# every child of the port starts from the forkserver (see module docstring)
_CTX = multiprocessing.get_context("forkserver")
_CTX.set_forkserver_preload(["repro_torch.core.procwire"])
_START_LOCK = threading.Lock()
# a child's start (the forkserver's own start the first time, unpickling
# the snapshot, a CUDA context) is waited for apart from the exchange's
# deadline, as a fork's was instant
START_TIMEOUT = 120.0


def _pow2ceil(n: int, floor: int = 16) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c


class HandlerNotPicklable(TypeError):
    """A service handler (or the state it closes over) does not pickle, so
    it cannot be sent to its service process. The port starts every service
    child from a forkserver, because CUDA does not survive ``fork``; a
    closure or lambda must become a module-level callable or a
    ``functools.partial``. Raised in the parent before any child starts."""


# ---------------------------------------------------------------------------
# the snapshot: what a child receives, pickled when it starts
# ---------------------------------------------------------------------------

def _fresh_lock(_lock):
    return threading.Lock, ()


def _fresh_rlock(_lock):
    return threading.RLock, ()


def _reduce_count(c):
    # itertools.count's own pickling is deprecated; its repr is
    # "count(n)" or "count(n, step)"
    args = [int(a) for a in repr(c)[6:-1].split(", ")]
    return itertools.count, tuple(args)


def _refuse(obj):
    raise TypeError(f"{type(obj).__name__} does not cross a process "
                    f"boundary")


class _SnapshotPickler(reduction.ForkingPickler):
    """``ForkingPickler`` (sockets and fds through the forkserver, CUDA
    tensors through torch's IPC reductions) plus: locks arrive as fresh
    locks, ``itertools.count`` as its current value, and a thread or a CUDA
    stream is refused."""

    def __init__(self, *args):
        super().__init__(*args)
        self.dispatch_table[type(threading.Lock())] = _fresh_lock
        self.dispatch_table[type(threading.RLock())] = _fresh_rlock
        self.dispatch_table[itertools.count] = _reduce_count
        self.dispatch_table[threading.Thread] = _refuse
        self.dispatch_table[torch.cuda.Stream] = _refuse


class _Snapshot:
    """Wraps an object that is pickled, with :class:`_SnapshotPickler`,
    while the child's arguments are (so fds and sockets inside it travel
    with the child), and unpickled only when the child calls
    :meth:`load`: after it has made its CUDA stream current."""

    def __init__(self, obj, what: str):
        self.obj, self.what = obj, what
        self.data: Optional[bytes] = None

    def __reduce__(self):
        buf = io.BytesIO()
        try:
            _SnapshotPickler(buf, pickle.HIGHEST_PROTOCOL).dump(self.obj)
        except Exception as e:
            raise HandlerNotPicklable(
                f"{self.what} cannot be sent to its service "
                f"process ({type(e).__name__}: {e}); the port starts every "
                f"service child from a forkserver because CUDA does not "
                f"survive fork, so a handler must pickle: use a "
                f"module-level callable or functools.partial instead of a "
                f"closure or lambda") from None
        return _Snapshot._frozen, (buf.getvalue(), self.what)

    @staticmethod
    def _frozen(data: bytes, what: str) -> "_Snapshot":
        snap = _Snapshot(None, what)
        snap.data = data
        return snap

    def load(self):
        return pickle.loads(self.data)


class _Fd:
    """A file descriptor that travels to the child (through the
    forkserver's fd passing) when pickled at the child's start."""

    def __init__(self, fd: int):
        self.fd = fd

    def __reduce__(self):
        return _Fd._rebuild, (reduction.DupFd(self.fd),)

    @staticmethod
    def _rebuild(df) -> "_Fd":
        return _Fd(df.detach())


# ---------------------------------------------------------------------------
# shared-memory segment lifecycle (create / map by fd / close / unlink)
# ---------------------------------------------------------------------------

# segments whose close() hit a BufferError (a caller still holds a view
# aliasing the mapping) — re-tried at the next segment close
_DEFERRED_CLOSE: List[object] = []
_DEFERRED_LOCK = threading.Lock()


def _sweep_deferred_closes() -> None:
    with _DEFERRED_LOCK:
        pending, _DEFERRED_CLOSE[:] = list(_DEFERRED_CLOSE), []
    for shm in pending:
        try:
            shm.close()
        except BufferError:
            with _DEFERRED_LOCK:
                _DEFERRED_CLOSE.append(shm)


def _neutralize(shm) -> None:
    """Last-resort detach for a mapping pinned by views at interpreter
    exit: drop the buffer/mmap references without closing (the OS reclaims
    the mapping at process death) and close the fd."""
    shm._buf = None
    shm._mmap = None
    fd = getattr(shm, "_fd", -1)
    if fd >= 0:
        try:
            os.close(fd)
        except OSError:
            pass
        shm._fd = -1


def _drain_deferred_at_exit() -> None:
    with _DEFERRED_LOCK:
        pending, _DEFERRED_CLOSE[:] = list(_DEFERRED_CLOSE), []
    for shm in pending:
        try:
            shm.close()
        except BufferError:
            _neutralize(shm)


atexit.register(_drain_deferred_at_exit)


def _finalize_owner_shm(shm) -> None:
    """GC / interpreter-exit backstop for an unclosed session: unlink the
    name (which also unregisters it from the resource tracker), then close
    the mapping."""
    try:
        shm.unlink()
    except FileNotFoundError:
        pass
    try:
        shm.close()
    except BufferError:
        _neutralize(shm)


class _ShmSegment:
    """One POSIX shared-memory segment viewed as a flat u32 array, created
    and owned by the client side. The child maps it from the fd it is
    passed (:meth:`fd`) and never unlinks it."""

    def __init__(self, nwords: int):
        from multiprocessing import shared_memory
        name = f"{SEGMENT_PREFIX}{os.getpid()}_{os.urandom(4).hex()}"
        self.shm = shared_memory.SharedMemory(
            name=name, create=True, size=nwords * 4)
        self.name = self.shm.name
        self.nbytes = nwords * 4
        self.u32 = np.frombuffer(self.shm.buf, np.uint32, count=nwords)
        self._closed = False
        self._finalizer = weakref.finalize(
            self, _finalize_owner_shm, self.shm)

    def fd(self) -> int:
        return self.shm._fd

    def close(self) -> None:
        """Idempotent close and unlink. A mapping pinned by a live view
        defers its close (re-tried later); the unlink happens now."""
        if self._closed:
            return
        self._closed = True
        self.u32 = None
        _sweep_deferred_closes()
        try:
            self.shm.close()
        except BufferError:
            with _DEFERRED_LOCK:
                _DEFERRED_CLOSE.append(self.shm)
        self._finalizer.detach()
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------------------
# cross-process doorbell
# ---------------------------------------------------------------------------

_DOORBELL_SPIN = 2              # bounded predicate probes before a park
_WAIT_SLICE = 0.1               # max single park slice (liveness re-check)

# process-local ledger of live doorbell socket fds; the proc test modules
# assert it drains to zero
_DOORBELL_FDS: set = set()
_DOORBELL_FDS_LOCK = threading.Lock()


def _track_doorbell(*socks) -> None:
    with _DOORBELL_FDS_LOCK:
        for s in socks:
            fd = s.fileno()
            if fd >= 0:
                _DOORBELL_FDS.add(fd)


def _untrack_doorbell(*socks) -> None:
    with _DOORBELL_FDS_LOCK:
        for s in socks:
            fd = s.fileno()
            if fd >= 0:
                _DOORBELL_FDS.discard(fd)


def open_doorbell_fds() -> int:
    """Number of doorbell socketpair fds currently open in THIS process."""
    with _DOORBELL_FDS_LOCK:
        return len(_DOORBELL_FDS)


# every ProcSession whose slab (the CUDA allocation its child maps through
# CUDA IPC, or the segment's slab rows on the CPU) is still held
_OPEN_SLABS: "weakref.WeakSet" = weakref.WeakSet()


def open_slabs() -> int:
    """Number of process sessions in THIS process that still hold the slab
    they share with a child (each ``close()`` lets go of it)."""
    return len(_OPEN_SLABS)


_LIVENESS_SLICE = 0.25          # client waits re-consult is_alive() at least
                                # this often (EOF is the fast path)


def _close_quietly(s) -> None:
    if s is None:
        return
    try:
        s.close()
    except OSError:
        pass


class ProcDoorbell:
    """A socketpair doorbell that crosses the process boundary.

    ``ring()`` is a coalesced non-blocking send; ``wait(pred, ...)`` probes
    the predicate, parks in bounded recv slices, drains rings and re-probes
    (the shared words are the truth, the bell only a hint). Once the child
    has its end, each side closes the end it does not use, so peer death
    is an EOF on the survivor's read end."""

    def __init__(self, rd: Optional[socket.socket] = None,
                 wr: Optional[socket.socket] = None):
        if rd is None and wr is None:
            rd, wr = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
            _track_doorbell(rd, wr)
        self._rd, self._wr = rd, wr
        if rd is not None:
            # the read end blocks with a bounded slice: one recv is both
            # the park and the drain
            rd.setblocking(True)
            rd.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO,
                          struct.pack("ll", 0, int(_WAIT_SLICE * 1e6)))
        if wr is not None:
            wr.setblocking(False)
        self._eof = False

    def keep_writer(self) -> None:
        """This process only rings: close the read end."""
        if self._rd is not None:
            _untrack_doorbell(self._rd)
            _close_quietly(self._rd)

    def keep_reader(self) -> None:
        """This process only waits: close the write end, so the peer's
        death (the last writer gone) is an EOF here."""
        if self._wr is not None:
            _untrack_doorbell(self._wr)
            _close_quietly(self._wr)

    def ring(self) -> None:
        try:
            self._wr.send(b"!")
        except OSError:                 # full pipe or dead peer: "rung"
            pass

    def _drain(self) -> bool:
        """Consume pending rings without blocking; True when the peer is
        gone."""
        try:
            while True:
                data = self._rd.recv(4096, socket.MSG_DONTWAIT)
                if data == b"":
                    self._eof = True
                    return True
        except BlockingIOError:
            return False
        except OSError:
            self._eof = True
            return True

    def wait(self, pred: Callable[[], bool], timeout: float,
             on_eof: Optional[Callable[[], None]] = None) -> bool:
        """Bounded wait for ``pred()``; returns its final value."""
        if pred():
            return True
        for _ in range(_DOORBELL_SPIN):
            if pred():
                return True
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            if pred():
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return pred()
            if self._eof:
                if on_eof is not None:
                    on_eof()
                return pred()
            if remaining >= _WAIT_SLICE:
                try:
                    if self._rd.recv(4096) == b"":
                        self._eof = True
                        if on_eof is not None:
                            on_eof()
                        return pred()
                except (BlockingIOError, TimeoutError):
                    pass                # slice elapsed; re-probe
                except OSError:         # fd closed under us (session close)
                    return pred()
                continue
            try:
                ready, _, _ = select.select([self._rd], [], [], remaining)
            except (OSError, ValueError):
                return pred()
            if ready and self._drain():
                if on_eof is not None:
                    on_eof()
                return pred()

    def close(self) -> None:
        socks = [s for s in (self._rd, self._wr) if s is not None]
        _untrack_doorbell(*socks)
        for s in socks:
            _close_quietly(s)


# ---------------------------------------------------------------------------
# process-backed session (shared machinery for shm_proc / mpklink*_proc)
# ---------------------------------------------------------------------------

_BUILT = False


def _build_kernels(device: torch.device) -> None:
    """On the card, build every kernel library before the first child
    starts: children load libraries and never build them."""
    global _BUILT
    if device.type != "cuda" or _BUILT:
        return
    from repro_torch.kernels import _build
    _build.build()
    _BUILT = True


class ProcSession(Session):
    """One client's channel to a service running in a child process.

    All exchange state lives in the segment (and, on the card, the slab
    beside it): a control block, a ring of slot headers, and a data slab
    carved by a client-owned backed :class:`framing.FrameArena`. The client
    stages a request (and a worst-case response area) into the slab,
    publishes the slot, and the child serves published slots in ticket
    order. The child starts lazily at the first exchange."""

    _mode = _MODE_SHM

    def __init__(self, transport: Transport, name: str):
        super().__init__(transport, name)
        self.capacity = transport.capacity
        self._nslots = transport.ring_slots
        self._cap_rows = _pow2ceil(self._side_rows(self.capacity))
        hdr_words = PROC_CTRL_WORDS + self._nslots * PROC_SLOT_WORDS
        self._hdr_rows = -(-hdr_words // framing.LANES)
        # the slab covers every live allocation: in-flight requests and
        # worst-case response areas, ~4 rings of them; the segment is fixed
        # at creation, so past that the typed CapacityError tells the
        # caller to poll first
        self._slab_rows = (4 * self._nslots + 8) * self._cap_rows
        on_host = self.device.type == "cpu"
        seg_rows = self._hdr_rows + (self._slab_rows if on_host else 0)
        self._seg = _ShmSegment(seg_rows * framing.LANES)
        self._slots = self._seg.u32[
            PROC_CTRL_WORDS:hdr_words].reshape(self._nslots, PROC_SLOT_WORDS)
        if on_host:
            # a freshly created segment is kernel-zeroed: no fill
            self._slab = torch.from_numpy(self._seg.u32[
                self._hdr_rows * framing.LANES:].reshape(
                    self._slab_rows, framing.LANES))
            self._slab_ipc = None
        else:
            self._slab_ipc = torch.empty((self._slab_rows, framing.LANES),
                                         dtype=torch.int32, device=self.device)
            self._slab = self._slab_ipc.view(torch.uint32)
        self.arena = framing.FrameArena(backing=self._slab)
        _OPEN_SLABS.add(self)
        # plain-int loads/stores on the control and slot words
        self._w = self._seg.shm.buf.cast("I")
        self._w[_W_MAGIC] = PROC_MAGIC
        self._w[_W_VERSION] = PROC_VERSION
        self._w[_W_MODE] = self._mode
        self._pbell_svc = ProcDoorbell()    # client rings → child waits
        self._pbell_cli = ProcDoorbell()    # child rings → client waits
        self._proc: Optional[multiprocessing.process.BaseProcess] = None
        # ticket → (req_buf, resp_buf, seq); slots a dead child may have
        # held are never released (crash invariant)
        self._inflight: Dict[int, Tuple] = {}
        self._staged: List[int] = []        # tickets staged, not yet published
        self._staged_bytes = 0
        self._req_cache: Optional[torch.Tensor] = None  # recycled request slot
        self._seq = 0
        self.sync_count = 0
        self.stream_syncs = 0               # parent stream syncs before a publish
        self._svc_sync_seen = 0
        self._sync_slk = threading.Lock()

    # -- subclass hooks ----------------------------------------------------
    @staticmethod
    def _side_rows(capacity: int) -> int:
        """Rows one direction of a capacity-sized message needs."""
        return -(-capacity // _ROW_BYTES)

    def _child_spec(self) -> dict:
        """What the child needs besides the segment (subclass hook)."""
        return {}

    # -- lifecycle ---------------------------------------------------------
    def ensure_started(self):
        """No service thread: the child starts lazily at the first
        exchange, so what is configured after connect() is in its
        snapshot."""

    def _ensure_proc(self):
        if self._proc is not None or self._closed:
            return
        with _START_LOCK:
            if self._proc is not None:
                return
            _build_kernels(self.device)
            handler = self.transport.handler
            spec = dict(
                name=self.name, mode=self._mode, nslots=self._nslots,
                seg_fd=_Fd(self._seg.fd()), seg_bytes=self._seg.nbytes,
                hdr_rows=self._hdr_rows, slab_rows=self._slab_rows,
                slab=self._slab_ipc, capacity=self.capacity,
                device=str(self.device),
                bell_rd=self._pbell_svc._rd, bell_wr=self._pbell_cli._wr,
                state=_Snapshot(dict(self._child_spec(), handler=handler),
                                f"handler {handler!r}"))
            proc = _CTX.Process(
                target=_service_child_main, args=(spec,), daemon=True,
                name=f"{self.transport.name}:{self.name}")
            proc.start()
            self._proc = proc
        # EOF discipline: the child holds its own ends now
        self._pbell_svc.keep_writer()
        self._pbell_cli.keep_reader()
        self._await_ready()

    def _await_ready(self):
        """Wait (bounded by :data:`START_TIMEOUT`) until the child has
        loaded its snapshot and reached its device."""
        w = self._w
        deadline = time.monotonic() + START_TIMEOUT

        def ready():
            return w[_W_READY] == 1 or self._crashed or self._closed
        while True:
            self._pbell_cli.wait(ready, _LIVENESS_SLICE,
                                 on_eof=self._mark_crashed)
            if w[_W_READY] == 1:
                return
            if self._dead():
                raise ServiceCrashed(
                    f"session {self.name!r}: service process died while "
                    f"starting (exit code {self._proc.exitcode}; its "
                    f"stderr says why)")
            if self._closed:
                raise TransportError(f"session {self.name!r} is closed")
            if time.monotonic() >= deadline:
                raise ServiceCrashed(
                    f"session {self.name!r}: service process not ready "
                    f"after {START_TIMEOUT}s")

    def _mark_crashed(self):
        self._crashed = True

    def _dead(self) -> bool:
        """Liveness backstop behind the EOF fast path."""
        if self._crashed:
            return True
        p = self._proc
        if p is not None and not p.is_alive():
            self._crashed = True
        return self._crashed

    def close(self):
        """Creator-side close: stop the child (cooperatively, then by
        force), drop every internal view, close and unlink the segment.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            if self._proc is not None:
                if self._w is not None:
                    self._w[_W_STOP] = 1
                self._pbell_svc.ring()
                self._proc.join(timeout=0.5)
                if self._proc.is_alive():
                    self._proc.terminate()
                    self._proc.join(timeout=0.5)
                if self._proc.is_alive():
                    self._proc.kill()
                    self._proc.join(timeout=0.5)
        finally:
            self._pbell_svc.close()
            self._pbell_cli.close()
            self._teardown()
            self._inflight.clear()
            self._req_cache = None
            self.arena = None
            self._slots = self._slab = self._slab_ipc = None
            _OPEN_SLABS.discard(self)
            if self._w is not None:
                self._w.release()
                self._w = None
            self._seg.close()
            if self.device.type == "cuda":
                torch.cuda.ipc_collect()    # slabs the children let go of
            self.transport._forget(self)

    # -- words the child publishes -------------------------------------------
    def child_launches(self) -> Dict[str, int]:
        """The child's CUDA kernel launch counts (``ops.LAUNCHES``), as it
        published them after its last completed slot (mod 2**32)."""
        w = self._w
        return {k: int(w[_W_LAUNCH0 + i]) for i, k in enumerate(ops.KERNELS)}

    # -- slot helpers ------------------------------------------------------
    def _acquire(self, rows: int) -> torch.Tensor:
        try:
            return self.arena.acquire(rows)
        except framing.FrameError as e:
            raise CapacityError(str(e)) from None

    def _sync_stream(self):
        """Order the slab writes queued on this process's stream before the
        slot state the child reads (the two processes share no stream)."""
        s = self.transport.stream
        if s is not None:
            s.synchronize()
            self.stream_syncs += 1

    def _await_slot(self, deadline: Optional[float]):
        """Credit wait over the shared slot-state word (CapacityError when
        the credit window expires, ResponseTimeout when the caller's
        tighter budget does)."""
        w, t = self._w, self._tickets
        state_i = (PROC_CTRL_WORDS
                   + (t % self._nslots) * PROC_SLOT_WORDS + _S_STATE)

        def free():
            return w[state_i] == _FREE or self._crashed or self._closed
        if free():
            return
        credit_deadline = time.monotonic() + self.transport.credit_wait
        eff_deadline = credit_deadline if deadline is None \
            else min(credit_deadline, deadline)
        self.flush()
        while True:
            self._pbell_cli.wait(
                free, min(_LIVENESS_SLICE,
                          max(0.0, eff_deadline - time.monotonic())),
                on_eof=self._mark_crashed)
            if w[state_i] == _FREE:
                return
            if self._dead():
                raise ServiceCrashed(
                    f"session {self.name!r}: service process died while "
                    f"waiting for a ring credit")
            if self._closed:
                raise TransportError(f"session {self.name!r} is closed")
            if time.monotonic() >= eff_deadline:
                if eff_deadline < credit_deadline:
                    raise ResponseTimeout(
                        f"call budget exhausted while waiting for a ring "
                        f"credit (ring full, {self._nslots} messages in "
                        f"flight)")
                raise CapacityError(
                    f"ring full ({self._nslots} messages in flight) — "
                    f"poll() before submitting more")

    def _too_big(self, nbytes: int) -> CapacityError:
        return CapacityError(f"{self.transport.name} segment "
                             f"({self.capacity}B) cannot hold {nbytes}B "
                             f"payload")

    def _write_slot(self, t: int, seq: int, req_buf, resp_buf, rows: int,
                    nbytes: int) -> int:
        """The slot header words of ticket ``t`` (the state word is left to
        the caller). → the slot's base word index."""
        w = self._w
        b = PROC_CTRL_WORDS + (t % self._nslots) * PROC_SLOT_WORDS
        w[b + _S_TICKET] = t & _U32
        w[b + _S_REQ_OFF] = self.arena.offset_rows(req_buf)
        w[b + _S_REQ_ROWS] = rows
        w[b + _S_REQ_NBYTES] = nbytes
        w[b + _S_RESP_OFF] = self.arena.offset_rows(resp_buf)
        w[b + _S_RESP_CAP] = resp_buf.shape[0]
        w[b + _S_RESP_ROWS] = 0
        w[b + _S_RESP_NBYTES] = 0
        w[b + _S_ERR] = _ERR_OK
        w[b + _S_SEQ] = seq & _U32
        return b

    def _take_bufs(self, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A request area of ``rows`` rows (the last one recycled when it
        fits) and a worst-case response area."""
        cached = self._req_cache
        if cached is not None and cached.shape[0] >= rows:
            self._req_cache, req_buf = None, cached
        else:
            req_buf = self._acquire(rows)
        try:
            return req_buf, self._acquire(self._cap_rows)
        except CapacityError:
            self.arena.release(req_buf)
            raise

    def _stage(self, seal, req_nbytes: int, req_rows: int,
               timeout: Optional[float] = None) -> int:
        """Allocate the request and response areas, let ``seal(req_buf) ->
        (rows, nbytes)`` write the request, and stage the slot header."""
        self._check_usable()
        if req_nbytes > self.capacity:
            raise self._too_big(req_nbytes)
        self._ensure_proc()
        self._await_slot(None if timeout is None
                         else time.monotonic() + timeout)
        req_buf, resp_buf = self._take_bufs(req_rows)
        try:
            rows, nbytes = seal(req_buf)
        except BaseException:
            self.arena.release(req_buf)
            self.arena.release(resp_buf)
            raise
        t = self._tickets
        seq = self._seq
        b = self._write_slot(t, seq, req_buf, resp_buf, rows, nbytes)
        self._w[b + _S_STATE] = _STAGED     # written last (publish flips it)
        with self._slk:
            self._tickets += 1
            self._seq += 1
        self._outstanding.add(t)
        self._inflight[t] = (req_buf, resp_buf, seq)
        self._staged.append(t)
        self._staged_bytes += rows * _ROW_BYTES
        return t

    # -- pipelined API -----------------------------------------------------
    @_on_stream
    def submit(self, payload, timeout: Optional[float] = None) -> int:
        raw = _raw(payload)
        n = raw.numel()
        rows = self._side_rows(max(1, n))

        def seal(buf: torch.Tensor):
            if n:
                buf.reshape(-1).view(torch.uint8)[:n].copy_(raw)
            return rows, n
        return self._stage(seal, n, rows, timeout=timeout)

    def _pre_publish_syncs(self, staged_bytes: int):
        """Subclass hook: the key-sync schedule of one publish (mpklink),
        run before the slot states flip."""

    @_on_stream
    def flush(self):
        if not self._staged or self._crashed:
            return
        staged, self._staged = self._staged, []
        staged_bytes, self._staged_bytes = self._staged_bytes, 0
        self._sync_stream()
        self._pre_publish_syncs(staged_bytes)
        w, nslots = self._w, self._nslots
        for t in staged:
            w[PROC_CTRL_WORDS + (t % nslots) * PROC_SLOT_WORDS
              + _S_STATE] = _PUBLISHED
        self._pbell_svc.ring()

    def _extract(self, b: int, rec: Tuple) -> torch.Tensor:
        """Subclass hook: a DONE slot's response area → what ``poll``
        returns (raises on guard failure). Nothing returned aliases the
        slab."""
        raise NotImplementedError

    def _settle(self, t: int, b: int, rec: Tuple) -> torch.Tensor:
        """The client half of a DONE slot: the response (or its typed
        error), then the slot and its areas are free."""
        req_buf, resp_buf, _seq = rec
        w = self._w
        self._fold_svc_syncs()
        if w[b + _S_ERR] == _ERR_BLOB:
            n = w[b + _S_RESP_NBYTES]
            blob = _host(resp_buf.reshape(-1).view(torch.uint8)[:n]).tobytes()
            w[b + _S_STATE] = _FREE
            self.arena.release(req_buf)
            self.arena.release(resp_buf)
            _raise_remote(blob)
        try:
            out = self._extract(b, rec)
        finally:
            # the response's readers (the guard's copy) are queued on this
            # stream, which is synced before the child may write the area
            # again
            w[b + _S_STATE] = _FREE
            if self._req_cache is None:
                self._req_cache = req_buf
            else:
                self.arena.release(req_buf)
            self.arena.release(resp_buf)
        return out

    def _await_done(self, t: int, b: int, deadline: float, eff: float):
        w = self._w
        tick = t & _U32

        def settled():
            return (w[b + _S_STATE] == _DONE and w[b + _S_TICKET] == tick) \
                or self._crashed or self._closed
        while True:
            # slice-bounded park: crash detection stays within
            # _LIVENESS_SLICE even without the EOF fast path
            self._pbell_cli.wait(
                settled, min(_LIVENESS_SLICE,
                             max(0.0, deadline - time.monotonic())),
                on_eof=self._mark_crashed)
            if w[b + _S_STATE] == _DONE and w[b + _S_TICKET] == tick:
                return
            if self._dead():
                raise ServiceCrashed(
                    f"session {self.name!r}: service process died with "
                    f"ticket {t} in flight")
            if self._closed:
                raise TransportError(f"session {self.name!r} is closed")
            if time.monotonic() >= deadline:
                self._poisoned = True
                raise ResponseTimeout(
                    f"{self.transport.name} response timed out after {eff}s")

    @_on_stream
    def poll(self, ticket: int, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_pollable()
        self.flush()
        if ticket not in self._outstanding:
            raise TransportError(
                f"unknown or already-redeemed ticket {ticket}")
        eff = self.transport.timeout if timeout is None else timeout
        b = PROC_CTRL_WORDS + (ticket % self._nslots) * PROC_SLOT_WORDS
        self._await_done(ticket, b, time.monotonic() + eff, eff)
        self._outstanding.discard(ticket)
        return self._settle(ticket, b, self._inflight.pop(ticket))

    def _fold_svc_syncs(self):
        """Fold the child's response-side key-sync count (a shared word)
        into the transport counters (mpklink)."""

    # -- lockstep API --------------------------------------------------------
    @_on_stream
    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_usable()
        self._ensure_proc()             # its start is not the exchange's
        eff = self.transport.timeout if timeout is None else timeout
        deadline = time.monotonic() + eff
        t = self.submit(payload, timeout=eff)
        self.flush()
        return self.poll(t, max(1e-3, deadline - time.monotonic()))

    @_on_stream
    def call_batch(self, payloads, return_exceptions: bool = False):
        """Ring-windowed pipelined batch: one publish (one key sync on the
        mpklink variants) a window of ring size. Per-message failures stay
        typed."""
        self._check_usable()
        out: List = []
        first: Optional[BaseException] = None
        cap = self._nslots
        for start in range(0, len(payloads), cap):
            tickets = [self.submit(p) for p in payloads[start:start + cap]]
            self.flush()
            for t in tickets:
                try:
                    out.append(self.poll(t))
                except Exception as e:  # noqa: PERF203 — per-ticket fate
                    if first is None:
                        first = e
                    out.append(e)
        if first is not None and not return_exceptions:
            raise first
        return out

    def _notify_crash(self, exc: ServiceCrashed):
        self._crashed = True


class ProcShmSession(ProcSession):
    """shm_proc: raw bytes in the slab, no framing — the paper's failing
    fixed-capacity baseline, across a process boundary."""

    _mode = _MODE_SHM

    def _extract(self, b: int, rec: Tuple) -> torch.Tensor:
        _req_buf, resp_buf, _seq = rec
        n = self._w[b + _S_RESP_NBYTES]
        return resp_buf.reshape(-1).view(torch.uint8)[:n].clone()


class ProcMPKLinkSession(ProcSession):
    """mpklink_proc / mpklink_opt_proc: a CA-enrolled per-session domain,
    sealed frames in the slab, PKRU key-sync ping-pong through shared
    control words. A publish performs ``ceil(published_bytes / chunk)``
    client→service syncs and each response drain pass one service-side
    sync, counted in a shared word."""

    _mode = _MODE_MPKLINK

    def __init__(self, transport: "ProcMPKLinkTransport", name: str):
        self.chunk = transport.chunk
        super().__init__(transport, name)
        self.registry = transport.registry
        self._sync_cache = None         # (epoch, key, rights, lo, hi)
        self._read_check_ep = None      # epoch the client READ check passed at
        # control plane (parent side, before the child starts)
        self._kp, _ = enroll(transport.ca, name)
        self.domain, self.key_client, self.key_server = \
            transport.ca.grant_channel(name, transport.server_name, RW)
        sess = transport.ca.session_seed(
            self._kp.private, transport.server_name)
        self.seed = mac_seed(self.domain,
                             self.registry.epoch(self.domain)) ^ sess

    @staticmethod
    def _side_rows(capacity: int) -> int:
        return framing.frame_rows(capacity)

    def _child_spec(self) -> dict:
        return {"seed": self.seed, "registry": self.registry,
                "key_server": self.key_server}

    def _teardown(self):
        self.registry.free_domain(self.domain)

    def _bump_sync(self, n: int = 1):
        with self._sync_slk:
            self.sync_count += n
        self.transport._bump_sync(n)

    def _post_sync(self, key, rights) -> int:
        """Client half of one PKRU synchronization: capability check
        (cached per registry epoch), PKRU/epoch words, bumped sync
        sequence. → the sequence the child must ack."""
        ep = self.registry.epoch(self.domain)
        cached = self._sync_cache
        if cached is None or cached[0] != ep or cached[1] is not key \
                or cached[2] != rights:
            self.registry.check(key, rights)
            pkru = int(self.registry.pkru_word((key,)))
            cached = self._sync_cache = (ep, key, rights,
                                         pkru & _U32, (pkru >> 32) & _U32)
        w = self._w
        w[_W_PKRU_LO] = cached[3]
        w[_W_PKRU_HI] = cached[4]
        w[_W_EPOCH] = ep & _U32
        self._bump_sync()
        seqv = (w[_W_SYNC_SEQ] + 1) & _U32
        w[_W_SYNC_SEQ] = seqv
        return seqv

    def _sync_key(self, key, rights):
        """One full PKRU synchronization round trip across the process
        boundary (crash-aware)."""
        seqv = self._post_sync(key, rights)
        w = self._w
        self._pbell_svc.ring()

        def acked():
            return w[_W_SYNC_ACK] == seqv or self._crashed or self._closed
        while True:
            self._pbell_cli.wait(acked, 0.5, on_eof=self._mark_crashed)
            if w[_W_SYNC_ACK] == seqv:
                return
            if self._dead():
                raise ServiceCrashed(
                    f"session {self.name!r}: service process died during "
                    f"a key-sync round trip")
            if self._closed:
                raise TransportError(
                    f"session {self.name!r} closed during a key sync")

    def _pre_publish_syncs(self, staged_bytes: int):
        """``ceil(staged_bytes / chunk)`` key syncs a publish: all but the
        last are full round trips; the last rides the publish's one ring
        and the child acks it before it drains."""
        syncs = max(1, -(-staged_bytes // self.chunk))
        for _ in range(syncs - 1):
            self._sync_key(self.key_client, WRITE)
        self._post_sync(self.key_client, WRITE)

    @_on_stream
    def submit(self, payload, timeout: Optional[float] = None) -> int:
        nbytes = _raw(payload).numel()
        rows = framing.frame_rows(nbytes)
        seq = self._seq

        def seal(buf: torch.Tensor):
            return framing.seal_into(buf, payload, seed=self.seed,
                                     seq=seq), nbytes
        return self._stage(seal, nbytes, rows, timeout=timeout)

    @_on_stream
    def request_into(self, nbytes: int, fill,
                     timeout: Optional[float] = None) -> torch.Tensor:
        """``fill(dst)`` writes the message straight into the request
        slot's payload bytes in the slab (a uint8 tensor on the session's
        device)."""
        self._check_usable()
        self._ensure_proc()
        eff = self.transport.timeout if timeout is None else timeout
        deadline = time.monotonic() + eff
        rows = framing.frame_rows(nbytes)
        seq = self._seq

        def seal(buf: torch.Tensor):
            fill(buf[1:rows].reshape(-1).view(torch.uint8)[:nbytes])
            framing.seal_prefilled(buf, nbytes, seed=self.seed, seq=seq)
            return rows, nbytes
        t = self._stage(seal, nbytes, rows, timeout=eff)
        self.flush()
        return self.poll(t, max(1e-3, deadline - time.monotonic()))

    @_on_stream
    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        """Lockstep exchange with submit → flush → poll fused: the slot is
        published directly, with the same words, sync schedule and error
        taxonomy. Mixed use falls back to the pipelined path."""
        if self._staged:
            return super().request(payload, timeout=timeout)
        self._check_usable()
        self._ensure_proc()             # its start is not the exchange's
        eff = self.transport.timeout if timeout is None else timeout
        deadline = time.monotonic() + eff
        nbytes = _raw(payload).numel()
        if nbytes > self.capacity:
            raise self._too_big(nbytes)
        self._ensure_proc()
        self._await_slot(deadline)
        rows = framing.frame_rows(nbytes)
        req_buf, resp_buf = self._take_bufs(rows)
        t = self._tickets
        seq = self._seq
        try:
            framing.seal_into(req_buf, payload, seed=self.seed, seq=seq)
        except BaseException:
            self.arena.release(req_buf)
            self.arena.release(resp_buf)
            raise
        b = self._write_slot(t, seq, req_buf, resp_buf, rows, nbytes)
        with self._slk:
            self._tickets += 1
            self._seq += 1
        self._sync_stream()
        self._pre_publish_syncs(rows * _ROW_BYTES)
        self._w[b + _S_STATE] = _PUBLISHED  # written last: syncs ride ahead
        self._pbell_svc.ring()
        # crash invariant: a slot a dead child may still reference is never
        # released (_await_done raises before _settle)
        self._await_done(t, b, deadline, eff)
        return self._settle(t, b, (req_buf, resp_buf, seq))

    def _extract(self, b: int, rec: Tuple) -> torch.Tensor:
        _req_buf, resp_buf, seq = rec
        ep = self.registry.epoch(self.domain)
        if self._read_check_ep != ep:
            self.registry.check(self.key_client, READ)
            self._read_check_ep = ep
        # mpklint: disable=MPK102 reason=verify_view returns guard_copy's owned copy (core/framing.py verify_view); no arena view escapes
        return framing.verify_view(resp_buf[:self._w[b + _S_RESP_ROWS]],
                                   seed=self.seed, expect_seq=seq)

    def _fold_svc_syncs(self):
        seen = self._w[_W_SVC_SYNC]
        delta = (seen - self._svc_sync_seen) & _U32
        if delta:
            self._svc_sync_seen = seen
            self._bump_sync(int(delta))


# ---------------------------------------------------------------------------
# the service child
# ---------------------------------------------------------------------------

class _Child:
    """The child's view of one session: the word plane, the slab, the
    doorbells and the handler."""

    def __init__(self, spec: dict):
        self.name = spec["name"]
        self.nslots = spec["nslots"]
        self.capacity = spec["capacity"]
        self.device = torch.device(spec["device"])
        fd = spec["seg_fd"].fd
        self._mm = mmap.mmap(fd, spec["seg_bytes"])
        os.close(fd)
        self.w = memoryview(self._mm).cast("I")
        slab = spec.pop("slab")
        if slab is None:
            lanes = framing.LANES
            self.slab = torch.from_numpy(np.frombuffer(
                self._mm, np.uint32, count=spec["slab_rows"] * lanes,
                offset=spec["hdr_rows"] * lanes * 4).reshape(-1, lanes))
        else:
            self.slab = slab.view(torch.uint32)
        self.bell_svc = ProcDoorbell(rd=spec["bell_rd"])
        self.bell_cli = ProcDoorbell(wr=spec["bell_wr"])
        self.mpk = self.w[_W_MODE] == _MODE_MPKLINK
        self.checked = False            # the snapshot registry cannot change
        self.pass_synced = False        # this drain pass's service key sync
        self.stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        state = spec.pop("state").load()
        self.seed = state.get("seed")
        self.registry = state.get("registry")
        self.key_server = state.get("key_server")
        self.handler = state["handler"]

    def sync(self):
        if self.stream is not None:
            self.stream.synchronize()

    def publish_launches(self):
        if self.stream is not None:
            for i, n in enumerate(ops.LAUNCHES.snapshot().values()):
                self.w[_W_LAUNCH0 + i] = n & _U32

    def close(self):
        self.handler = None
        self.slab = None
        self.w.release()
        gc.collect()                    # release the CUDA IPC slab


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else 0


def _service_child_main(spec: dict) -> None:
    """Entry point of a service process. Runs the drain loop and leaves
    through ``os._exit``, so no finalizer or atexit hook of the snapshot
    runs in the child. A child that cannot reach its device, map its slab
    or load its handler prints why and exits 1 (the parent sees the EOF as
    a typed ServiceCrashed)."""
    code = 0
    child = None
    try:
        gc.freeze()
        from repro_torch.kernels import _build
        _build.ALLOW_BUILD = False      # the parent built the libraries
        device = torch.device(spec["device"])
        if device.type == "cuda":
            torch.cuda.set_device(_index(device))
            ctx = torch.cuda.stream(torch.cuda.Stream(device))
        else:
            torch.set_num_threads(1)
            ctx = contextlib.nullcontext()
        ops.LAUNCHES.reset()
        with ctx:
            child = _Child(spec)
            child.w[_W_READY] = 1
            child.bell_cli.ring()
            _child_loop(child)
    except BaseException:               # noqa: B036 — the child's last word
        code = 1
        traceback.print_exc()
        sys.stderr.flush()
    finally:
        try:
            if child is not None:
                child.close()
        finally:
            os._exit(code)


def _child_loop(c: _Child) -> None:
    w = c.w
    nslots = c.nslots
    orphaned = []

    def pending() -> bool:
        if orphaned or w[_W_STOP]:
            return True
        if w[_W_SYNC_SEQ] != w[_W_SYNC_ACK]:
            return True
        head = w[_W_HEAD]
        b = PROC_CTRL_WORDS + (head % nslots) * PROC_SLOT_WORDS
        return w[b + _S_STATE] == _PUBLISHED \
            and w[b + _S_TICKET] == (head & _U32)

    while True:
        if w[_W_STOP] or orphaned:
            return
        if _child_drain(c):
            continue
        if w[_W_SYNC_SEQ] != w[_W_SYNC_ACK]:
            # a pending sync with no published work is a blocking chunk
            # round trip: ack it and wake the writer
            w[_W_SYNC_ACK] = w[_W_SYNC_SEQ]
            c.bell_cli.ring()
            continue
        c.bell_svc.wait(pending, _WAIT_SLICE * 2,
                        on_eof=lambda: orphaned.append(True))


def _child_done(c: _Child, b: int) -> None:
    """Publish a completed slot: the slab writes are complete (stream
    synced) before the state word says so. The pass's one response-side
    key sync (mpklink) is counted before its first slot completes, so the
    client that reads that slot folds it in."""
    c.sync()
    c.publish_launches()
    w = c.w
    if c.mpk and not c.pass_synced:
        w[_W_SVC_SYNC] = (w[_W_SVC_SYNC] + 1) & _U32
        c.pass_synced = True
    w[b + _S_STATE] = _DONE             # written last


def _child_error(c: _Child, b: int, exc: BaseException) -> None:
    w = c.w
    blob = _pack_error(exc)[:w[b + _S_RESP_CAP] * _ROW_BYTES]
    off = w[b + _S_RESP_OFF]
    area = c.slab[off:off + w[b + _S_RESP_CAP]].reshape(-1).view(torch.uint8)
    area[:len(blob)].copy_(torch.frombuffer(bytearray(blob), dtype=torch.uint8))
    w[b + _S_RESP_NBYTES] = len(blob)
    w[b + _S_ERR] = _ERR_BLOB
    _child_done(c, b)


def _as_bytes(r) -> torch.Tensor:
    """A handler's response as flat uint8 bytes, where it lies."""
    if isinstance(r, (bytes, bytearray, memoryview)):
        return torch.frombuffer(bytearray(r), dtype=torch.uint8) if len(r) \
            else torch.empty(0, dtype=torch.uint8)
    return _raw(r)


def _child_drain(c: _Child) -> bool:
    """Serve published slots in ticket order. One pass = one response-side
    key sync (mpklink mode) and one doorbell ring, however many slots
    completed."""
    w, slab, mpk = c.w, c.slab, c.mpk
    completed = 0
    c.pass_synced = False
    while True:
        head = w[_W_HEAD]
        b = PROC_CTRL_WORDS + (head % c.nslots) * PROC_SLOT_WORDS
        if w[b + _S_STATE] != _PUBLISHED \
                or w[b + _S_TICKET] != (head & _U32):
            break
        # a publish's final key sync rides its ring: ack it before serving
        # the slot, so no slot is drained under an unacknowledged update
        if w[_W_SYNC_SEQ] != w[_W_SYNC_ACK]:
            w[_W_SYNC_ACK] = w[_W_SYNC_SEQ]
        w[_W_HEAD] = (head + 1) & _U32
        req_off, req_rows = w[b + _S_REQ_OFF], w[b + _S_REQ_ROWS]
        if mpk:
            checked = c.checked
            if not checked:
                c.registry.check(c.key_server, READ)
            try:
                req = framing.verify_view(
                    slab[req_off:req_off + req_rows], seed=c.seed,
                    expect_seq=w[b + _S_SEQ])
            except framing.FrameError as e:
                _child_error(c, b, e)
                completed += 1
                continue
            if not checked:
                c.registry.check(c.key_server, WRITE)
                c.checked = True
        else:
            req = slab[req_off:req_off + req_rows].reshape(-1) \
                .view(torch.uint8)[:w[b + _S_REQ_NBYTES]]
        try:
            resp = _as_bytes(c.handler(req))
        except HandlerCrash:
            # the real crash fault: the service process dies by kill -9,
            # possibly holding this slot; the parent sees the doorbell EOF
            os.kill(os.getpid(), signal.SIGKILL)
        except DropResponse:            # injected wire drop: this slot
            w[b + _S_STATE] = _DROPPED  # never completes; its poll expires
            continue
        except Exception as e:
            _child_error(c, b, e)
            completed += 1
            continue
        resp_off, resp_cap = w[b + _S_RESP_OFF], w[b + _S_RESP_CAP]
        area = slab[resp_off:resp_off + resp_cap]
        n = resp.numel()
        if mpk:
            rows = framing.frame_rows(n)
            if rows > resp_cap:
                _child_error(c, b, CapacityError(
                    f"response ({n}B) exceeds the session's "
                    f"{c.capacity}B response area"))
                completed += 1
                continue
            framing.seal_into(area, resp, seed=c.seed, seq=w[b + _S_SEQ])
            w[b + _S_RESP_ROWS] = rows
        else:
            if n > resp_cap * _ROW_BYTES:
                _child_error(c, b, CapacityError(
                    f"shm segment ({c.capacity}B) cannot hold {n}B "
                    f"response"))
                completed += 1
                continue
            if n:
                area.reshape(-1).view(torch.uint8)[:n].copy_(resp)
        w[b + _S_RESP_NBYTES] = n
        w[b + _S_ERR] = _ERR_OK
        _child_done(c, b)
        completed += 1
    if completed:
        c.bell_cli.ring()
    return bool(completed)


# ---------------------------------------------------------------------------
# process-backed transports
# ---------------------------------------------------------------------------

class ProcShmTransport(ShmTransport):
    """shm over a real process boundary (a POSIX segment a session, the
    service in a child). Same fixed-capacity semantics as the in-process
    shm transport."""

    name = "shm_proc"

    def _make_session(self, name):
        return ProcShmSession(self, name)


class ProcMPKLinkTransport(MPKLinkTransport):
    """MPKLink across a real process boundary: per-chunk PKRU key-sync
    ping-pong through shared control words, sealed frames in a shared
    slab, the service in a child. ``capacity`` bounds one message
    direction (the segment is sized at session creation)."""

    name = "mpklink_proc"
    DEFAULT_CAPACITY = 256 * 1024

    def __init__(self, handler: Handler, chunk: Optional[int] = None, *,
                 capacity: int = DEFAULT_CAPACITY, **kw):
        self.capacity = capacity
        super().__init__(handler, chunk=chunk, **kw)

    def _make_session(self, name):
        return ProcMPKLinkSession(self, name)


class ProcMPKLinkOptTransport(ProcMPKLinkTransport):
    """Process-backed mpklink_opt: one key sync per publish."""

    name = "mpklink_opt_proc"

    def __init__(self, handler: Handler, **kw):
        kw.setdefault("chunk", 1 << 62)
        super().__init__(handler, **kw)


# ---------------------------------------------------------------------------
# baseline pair: loopback REST (HTTP/1.1) and length-prefixed TCP RPC
# ---------------------------------------------------------------------------

class _Lifeline:
    """Parent-death watchdog for the baseline servers: the child reads its
    end; EOF (the parent exited or closed the lifeline) → ``os._exit``."""

    def __init__(self):
        self._rd, self._wr = socket.socketpair(
            socket.AF_UNIX, socket.SOCK_STREAM)

    @staticmethod
    def child_watch(rd: socket.socket):
        def watch():
            try:
                while rd.recv(64) not in (b"", None):
                    pass
            except OSError:
                pass
            os._exit(0)
        threading.Thread(target=watch, daemon=True).start()

    def parent_side(self):
        _close_quietly(self._rd)

    def await_ready(self, proc) -> None:
        """Wait (bounded by :data:`START_TIMEOUT`) for the server's ready
        byte; its death first is a typed ServiceCrashed."""
        self._wr.settimeout(START_TIMEOUT)
        try:
            got = self._wr.recv(1)
        except OSError:
            got = b""
        finally:
            self._wr.settimeout(None)
        if got != b"R":
            proc.join(timeout=1.0)
            raise ServiceCrashed(
                f"{proc.name}: server process did not start (exit code "
                f"{proc.exitcode}; its stderr says why)")

    def close(self):
        for s in (self._rd, self._wr):
            _close_quietly(s)


def _handle_host(handler, req_bytes: bytes, device: torch.device) -> np.ndarray:
    """Run a baseline server's handler: the request copied to the device
    once (as pipe, uds and grpc_sim do), the response back as host bytes."""
    return _host(_as_bytes(handler(_from_host(req_bytes, device))))


def _serve_rest(listener: socket.socket, handler, device) -> None:
    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # real REST stacks disable Nagle; without it split header/body
        # writes meet delayed ACK in a ~40 ms stall
        disable_nagle_algorithm = True

        def _reply(self, status: int, doc: dict):
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0) or 0)
            # the paper's REST model: a JSON document with the binary
            # payload base64'd inside, both ways
            doc = json.loads(self.rfile.read(n))
            try:
                resp = _handle_host(handler, base64.b64decode(doc["payload"]),
                                    device)
            except HandlerCrash:
                os.kill(os.getpid(), signal.SIGKILL)
            except DropResponse:        # injected wire drop: no reply
                self.close_connection = True
                return
            except Exception as e:
                return self._reply(500, {"error": base64.b64encode(
                    _pack_error(e)).decode("ascii")})
            self._reply(200, {"result": base64.b64encode(
                resp.tobytes()).decode("ascii")})

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler,
                                 bind_and_activate=False)
    server.socket.close()
    server.socket = listener
    server.server_address = listener.getsockname()
    server.daemon_threads = True
    server.serve_forever(poll_interval=0.2)


def _serve_sockrpc(listener: socket.socket, handler, device) -> None:
    def serve_conn(conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                n = _LEN.unpack(bytes(_recv_exact(conn, 8)))[0]
                req = bytes(_recv_exact(conn, n))
            except (TransportError, OSError):
                return
            try:
                resp = _handle_host(handler, req, device)
            except HandlerCrash:
                os.kill(os.getpid(), signal.SIGKILL)
            except DropResponse:        # injected wire drop: no reply
                continue
            except Exception as e:
                blob = _pack_error(e)
                try:
                    conn.sendall(_LEN.pack(len(blob) | _ERR_BIT))
                    conn.sendall(blob)
                except OSError:
                    return
                continue
            try:
                conn.sendall(_LEN.pack(resp.nbytes))
                conn.sendall(resp)
            except OSError:
                return

    while True:
        conn, _addr = listener.accept()
        threading.Thread(target=serve_conn, args=(conn,), daemon=True).start()


_SERVERS = {"rest": _serve_rest, "sockrpc": _serve_sockrpc}


def _server_child_main(kind: str, listener: socket.socket,
                       lifeline: socket.socket, handler: _Snapshot,
                       device: str) -> None:
    """Entry point of a baseline server process (see
    :func:`_service_child_main` for the exit discipline)."""
    code = 0
    try:
        gc.freeze()
        from repro_torch.kernels import _build
        _build.ALLOW_BUILD = False
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(_index(dev))
        else:
            torch.set_num_threads(1)
        serve, h = _SERVERS[kind], handler.load()
        lifeline.sendall(b"R")          # ready: the parent may time requests
        _Lifeline.child_watch(lifeline)
        serve(listener, h, dev)
    except BaseException:               # noqa: B036 — the child's last word
        code = 1
        traceback.print_exc()
        sys.stderr.flush()
    finally:
        os._exit(code)


class _ServerProcessTransport(Transport):
    """Shared machinery for the REST/sockrpc baselines: one server process
    a transport (started lazily, adopting a listener the parent bound on
    127.0.0.1), N client sessions with persistent connections. The parent
    closes its copy of the listener once the child has it, so a dead server
    is an immediate refused or reset connection, classified as
    :class:`ServiceCrashed`."""

    def __init__(self, handler: Handler, timeout: float = 120.0,
                 ring_slots: Optional[int] = None,
                 credit_wait: Optional[float] = None, **kw):
        super().__init__(handler, timeout=timeout, ring_slots=ring_slots,
                         credit_wait=credit_wait, **kw)
        self.port: Optional[int] = None
        self._server_proc = None
        self._lifeline: Optional[_Lifeline] = None
        self._server_lock = threading.Lock()
        self._transport_closed = False

    def _ensure_server(self):
        with self._server_lock:
            if self._transport_closed:
                raise TransportError(f"transport {self.name} is closed")
            if self._server_proc is not None and self._server_proc.is_alive():
                return
            if self._lifeline is not None:
                self._lifeline.close()
                self._lifeline = None
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind(("127.0.0.1", 0))
            listener.listen(128)
            lifeline = _Lifeline()
            try:
                with _START_LOCK:
                    _build_kernels(self.device)
                    proc = _CTX.Process(
                        target=_server_child_main,
                        args=(self.name, listener, lifeline._rd,
                              _Snapshot(self.handler, "handler"),
                              str(self.device)),
                        daemon=True, name=f"{self.name}:server")
                    proc.start()
            except BaseException:
                lifeline.close()
                raise
            finally:
                self.port = listener.getsockname()[1]
                listener.close()        # child death ⇒ connection refused
            lifeline.parent_side()
            self._server_proc = proc
            self._lifeline = lifeline
            lifeline.await_ready(proc)

    def kill_server(self):
        """Test hook: SIGKILL the server process (the real crash fault)."""
        with self._server_lock:
            if self._server_proc is not None and self._server_proc.is_alive():
                self._server_proc.kill()
                self._server_proc.join(timeout=1.0)

    def close(self):
        super().close()                 # close sessions first
        with self._server_lock:
            self._transport_closed = True
            if self._lifeline is not None:
                self._lifeline.close()  # EOF → the child's watchdog exits
                self._lifeline = None
            if self._server_proc is not None:
                self._server_proc.join(timeout=0.5)
                if self._server_proc.is_alive():
                    self._server_proc.kill()
                    self._server_proc.join(timeout=0.5)
                self._server_proc = None


class _BaselineSession(Session):
    """Lockstep client session over a private connection to the server
    process; submit/poll/call_batch ride the base lockstep fallback."""

    def ensure_started(self):
        """No in-process service thread: the server lives in the
        transport's child process."""

    def _classify(self, exc: BaseException) -> BaseException:
        self._conn_reset()
        return ServiceCrashed(
            f"session {self.name!r}: server process connection failed "
            f"({type(exc).__name__}: {exc})")

    def _conn_reset(self):
        pass

    def _teardown(self):
        self._conn_reset()


class RESTSession(_BaselineSession):
    def __init__(self, transport, name):
        super().__init__(transport, name)
        self._conn: Optional[http.client.HTTPConnection] = None

    def _conn_reset(self):
        if self._conn is not None:
            _close_quietly(self._conn)
            self._conn = None

    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_usable()
        self.transport._ensure_server()
        eff = self.transport.timeout if timeout is None else timeout
        raw = _host(_raw(payload))
        try:
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    "127.0.0.1", self.transport.port, timeout=eff)
            self._conn.timeout = eff
            if self._conn.sock is not None:
                self._conn.sock.settimeout(eff)
            # an honest REST request: a JSON body with the binary payload
            # base64'd into it — the serialization the paper charges REST
            self._conn.request(
                "POST", "/invoke",
                body=json.dumps({"payload": base64.b64encode(
                    raw.tobytes()).decode("ascii")}),
                headers={"Content-Type": "application/json"})
            r = self._conn.getresponse()
            body = r.read()
        except socket.timeout:
            self._poisoned = True       # a late response is still in the
            self._conn_reset()          # stream: never reuse the connection
            raise ResponseTimeout(f"rest response timed out after {eff}s")
        except (ConnectionError, http.client.HTTPException, OSError) as e:
            raise self._classify(e) from None
        doc = json.loads(body)
        if r.status != 200:
            _raise_remote(base64.b64decode(doc["error"]))
        return _from_host(base64.b64decode(doc["result"]), torch.device("cpu"))


class RESTTransport(_ServerProcessTransport):
    """The paper's REST baseline, made honest: a real HTTP/1.1 server
    (``ThreadingHTTPServer``, a thread a connection) in its own process on
    loopback TCP; requests are ``POST /invoke`` with a JSON body whose
    binary payload rides base64, handler errors come back as status 500
    with a typed error blob, and a handler crash kills the whole server
    process."""

    name = "rest"

    def _make_session(self, name):
        return RESTSession(self, name)


class SockRPCSession(_BaselineSession):
    def __init__(self, transport, name):
        super().__init__(transport, name)
        self._sock: Optional[socket.socket] = None

    def _conn_reset(self):
        if self._sock is not None:
            _close_quietly(self._sock)
            self._sock = None

    def request(self, payload, timeout: Optional[float] = None) -> torch.Tensor:
        self._check_usable()
        self.transport._ensure_server()
        eff = self.transport.timeout if timeout is None else timeout
        raw = _host(_raw(payload))
        try:
            if self._sock is None:
                self._sock = socket.create_connection(
                    ("127.0.0.1", self.transport.port), timeout=eff)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
            self._sock.settimeout(eff)
            self._sock.sendall(_LEN.pack(raw.nbytes))
            self._sock.sendall(raw)
            n = _LEN.unpack(bytes(_recv_exact(self._sock, 8)))[0]
            if n & _ERR_BIT:
                _raise_remote(bytes(_recv_exact(self._sock, n & ~_ERR_BIT)))
            return _from_host(_recv_exact(self._sock, n), torch.device("cpu"))
        except socket.timeout:
            self._poisoned = True
            self._conn_reset()
            raise ResponseTimeout(f"sockrpc response timed out after {eff}s")
        except ServiceCrashed:
            # _recv_exact classified a mid-read EOF (a killed server)
            self._conn_reset()
            raise
        except (ConnectionError, OSError) as e:
            raise self._classify(e) from None


class SockRPCTransport(_ServerProcessTransport):
    """Length-prefixed socket RPC over loopback TCP: the uds transport's
    ``_LEN`` / ``_ERR_BIT`` wire protocol with a real TCP server process (a
    thread a connection) on the other end."""

    name = "sockrpc"

    def _make_session(self, name):
        return SockRPCSession(self, name)


# ---------------------------------------------------------------------------
# registries (kept apart from transports.TRANSPORTS: the in-process matrix
# keeps its in-process semantics; gateway name resolution merges)
# ---------------------------------------------------------------------------

PROC_TRANSPORTS = {
    ProcShmTransport.name: ProcShmTransport,
    ProcMPKLinkTransport.name: ProcMPKLinkTransport,
    ProcMPKLinkOptTransport.name: ProcMPKLinkOptTransport,
}

BASELINE_TRANSPORTS = {
    RESTTransport.name: RESTTransport,
    SockRPCTransport.name: SockRPCTransport,
}
