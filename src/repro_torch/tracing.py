"""Span recording for the port: what the host does, on the profiler's clock.

A span is one stretch of host work on one thread: its name, start and end,
thread, the id of its parent span (the innermost span open on the thread
when it opened) and the id of the call it serves (the gateway's ``(cid,
seq)`` as ``cid << 32 | seq``; a span without one takes its parent's). It
may carry a few integer attributes; counts are recorded as attributes of
the span at whose boundary they happen.

The recorder is off by default and is armed and disarmed by API only
(:func:`arm`, :func:`disarm`, :func:`drain`). Off, a site costs a call and
one attribute test and allocates nothing: :func:`span` hands back a shared
null span. Armed, each thread appends its finished spans to a buffer of its
own, with no lock (the per-thread shard registry :class:`ThreadShards`,
which ``framing.FrameStats`` shares), and while a ``torch.profiler`` run
is on, every span opens a ``record_function`` range of its name.
:func:`phase` marks the train step's phases, which open their range
whether or not the recorder is armed.

Spans are stamped with ``time.perf_counter_ns()``. :func:`drain` returns
them in the clock domain of a ``torch.profiler`` trace, Unix nanoseconds
(what ``kineto_results.trace_start_ns()`` and each event's ``start_ns()``
use), by an offset measured when the recorder is armed, so the program's
spans and the device's kernels, runtime calls and idle gaps lie on one
time axis.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from torch._C._autograd import _profiler_enabled as _profiler_on
from torch.profiler import record_function


class ThreadShards:
    """A registry of per-thread shards: each thread owns a private shard,
    made by :meth:`_new_shard` and registered once under ``_rlock``, so the
    owner writes it with no lock. Readers walk ``_shards`` (pairs of thread
    and shard) under ``_rlock``; :meth:`_fold_dead_locked` hands the shards
    of dead threads to :meth:`_retire` and drops them, so a process cycling
    many threads does not accumulate them."""

    def __init__(self):
        self._rlock = threading.Lock()      # guards the shard registry only
        self._local = threading.local()
        self._shards: List[Tuple[threading.Thread, Any]] = []

    def _new_shard(self):
        raise NotImplementedError

    def _retire(self, shard) -> None:
        """A dead thread's shard, under ``_rlock``: fold what it holds."""

    def _shard(self):
        s = getattr(self._local, "s", None)
        if s is None:
            s = self._new_shard()
            self._local.s = s
            with self._rlock:
                self._shards.append((threading.current_thread(), s))
        return s

    def _fold_dead_locked(self) -> None:
        live = []
        for th, s in self._shards:
            if th.is_alive():
                live.append((th, s))
            else:                           # no further writes possible
                self._retire(s)
        self._shards = live


class SpanRecord(NamedTuple):
    """One finished span as :func:`drain` returns it (times in Unix ns)."""
    name: str
    start_ns: int
    end_ns: int
    thread: int                 # threading.get_native_id() of its thread
    ident: int                  # threading.get_ident() of its thread
    span: int                   # its id (ids start at 1)
    parent: int                 # the enclosing span's id, 0 at the top
    call: Optional[int]         # cid << 32 | seq of the call it serves
    attrs: Optional[Dict[str, int]]


class _Buffer:
    """One thread's spans: the open ones (a stack) and the finished ones,
    as tuples in ``perf_counter_ns`` time."""
    __slots__ = ("stack", "done", "thread", "ident")

    def __init__(self):
        self.stack: List["Span"] = []
        self.done: List[tuple] = []
        self.thread = threading.get_native_id()
        self.ident = threading.get_ident()


_IDS = itertools.count(1)


class Span:
    """An armed span; a context manager. ``call`` and :meth:`set` may be
    given while it is open."""
    __slots__ = ("name", "call", "attrs", "span", "parent", "t0", "_buf", "_rf")

    def __init__(self, name: str, call: Optional[int] = None):
        self.name, self.call, self.attrs = name, call, None

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs: int) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        buf = getattr(RECORDER._local, "s", None) or RECORDER._shard()
        self._buf = buf
        self.span = next(_IDS)
        stack = buf.stack
        if stack:
            top = stack[-1]
            self.parent = top.span
            if self.call is None:
                self.call = top.call
        else:
            self.parent = 0
        stack.append(self)
        # a range only where a profiler is on to record it
        self._rf = record_function(self.name) if _profiler_on() else None
        if self._rf is not None:
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        buf = self._buf
        buf.stack.pop()
        buf.done.append((self.name, self.t0, t1, self.span, self.parent,
                         self.call, self.attrs))
        return False


class _NullSpan:
    """What a site gets while the recorder is off: does nothing, is falsy,
    and is shared (no allocation)."""
    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: int) -> None:
        pass


NULL = _NullSpan()


class Recorder(ThreadShards):
    """The process's span recorder (:data:`RECORDER`). ``armed`` is the one
    attribute a site tests; ``arms`` counts the times it was armed."""

    def __init__(self):
        super().__init__()
        self.armed = False
        self.arms = 0
        self.offset_ns = 0          # Unix ns − perf_counter_ns, at arming
        self._retired: List[Tuple[_Buffer, List[tuple]]] = []

    def _new_shard(self) -> _Buffer:
        return _Buffer()

    def _retire(self, buf: _Buffer) -> None:
        if buf.done:
            self._retired.append((buf, buf.done))

    def arm(self) -> None:
        """Start recording (measures the clock offset first)."""
        offset = clock_offset_ns()
        with self._rlock:
            self.offset_ns = offset
            self.arms += 1
        self.armed = True

    def disarm(self) -> None:
        """Stop recording: spans open now still finish and are kept."""
        self.armed = False

    def open_spans(self) -> int:
        """Spans open now on every thread (each was opened while armed)."""
        with self._rlock:
            bufs = [b for _, b in self._shards]
        return sum(len(b.stack) for b in bufs)

    def drain(self) -> List[SpanRecord]:
        """Every finished span so far, oldest first, in Unix ns, taken out
        of the buffers. A span with no call id takes the nearest ancestor's
        among those drained together."""
        taken: List[Tuple[_Buffer, List[tuple]]] = []
        with self._rlock:
            self._fold_dead_locked()
            taken, self._retired = self._retired, []
            bufs = [b for _, b in self._shards]
        for buf in bufs:
            n = len(buf.done)               # the owner may append meanwhile:
            taken.append((buf, buf.done[:n]))   # take a prefix, drop it
            del buf.done[:n]
        off = self.offset_ns
        out = [SpanRecord(name, t0 + off, t1 + off, buf.thread, buf.ident, sid,
                          parent, call, attrs)
               for buf, done in taken
               for name, t0, t1, sid, parent, call, attrs in done]
        calls = {r.span: r.call for r in out}
        parents = {r.span: r.parent for r in out}
        for i, r in enumerate(out):
            if r.call is None:
                p = r.parent
                while p and calls.get(p) is None and p in parents:
                    p = parents[p]
                if calls.get(p) is not None:
                    out[i] = r._replace(call=calls[p])
        out.sort(key=lambda r: r.start_ns)
        return out


RECORDER = Recorder()


def clock_offset_ns(rounds: int = 16) -> int:
    """Unix ns minus ``perf_counter_ns``, from the read of the wall clock
    bracketed most tightly by two reads of the counter."""
    best = None
    for _ in range(rounds):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def span(name: str, call: Optional[int] = None):
    """A span named ``name`` over a ``with`` block, or the shared null span
    while the recorder is off."""
    if not RECORDER.armed:
        return NULL
    return Span(name, call)


def phase(name: str, **attrs: int):
    """A phase of the train step: the ``record_function`` range ``name``
    always, and while the recorder is armed a span of that name too."""
    if not RECORDER.armed:
        return record_function(name)
    sp = Span(name)
    if attrs:
        sp.attrs = attrs
    return sp


def emit(name: str, start_ns: int, end_ns: int, call: Optional[int] = None,
         **attrs: int) -> None:
    """Record a finished span with stamps the caller kept
    (``perf_counter_ns`` time), on the calling thread, under its innermost
    open span. Only while armed."""
    if not RECORDER.armed:
        return
    buf = RECORDER._shard()
    parent = buf.stack[-1].span if buf.stack else 0
    buf.done.append((name, start_ns, end_ns, next(_IDS), parent, call,
                     attrs or None))


def _open_stack() -> Optional[List[Span]]:
    """The calling thread's open spans (None or empty when it has none)."""
    buf = getattr(RECORDER._local, "s", None)
    return None if buf is None else buf.stack


def set_call(cid: int, seq: int) -> None:
    """Give the calling thread's innermost open span the id of the gateway
    call ``(cid, seq)`` (:func:`call_id`); its open children keep theirs."""
    stack = _open_stack()
    if stack:
        stack[-1].call = call_id(cid, seq)


def current_call() -> Optional[int]:
    """The call id of the calling thread's innermost open span (None when
    it has none: the recorder was off when it began its work)."""
    stack = _open_stack()
    return stack[-1].call if stack else None


def call_id(cid: int, seq: int) -> int:
    """A gateway call's id: the client's id and the frame's sequence word."""
    return (cid << 32) | (seq & 0xFFFFFFFF)


def arm() -> None:
    RECORDER.arm()


def disarm() -> None:
    RECORDER.disarm()


def drain() -> List[SpanRecord]:
    return RECORDER.drain()
