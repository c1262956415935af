"""Typed transport errors, ``fast_mac`` and the service step (the port of
the parts of ``repro.core.transports`` that the serving path runs).

:func:`serve_frame` is the one-frame step of the reference's
``MPKLinkSession._serve_loop``: verify the request frame (the
``guard_copy`` kernel), run the handler with the frame's lane-10 deadline
and lane-12 priority published (``core.gateway``), and seal the response
(``framing.fast_mac``). :func:`serve_batch` is its batch-envelope twin onto
a batch handler (``EngineService.handler_batch``), with per-item typed
errors. The threads, rings, doorbells, PKRU/CA emulation and process
fleets of the reference transports are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import time
from typing import Callable, List, Sequence, Union

import torch

from repro_torch.core import framing
from repro_torch.core import gateway
# the streaming MAC lives in framing (its seal path); it is re-exported
# here, where the reference keeps it
from repro_torch.core.framing import fast_mac  # noqa: F401


class TransportError(RuntimeError):
    pass


class ResponseTimeout(TransportError):
    """The response wait expired (the service may still be alive)."""


class DeadlineExpired(ResponseTimeout):
    """The request's propagated deadline (the lane-10 budget word) expired
    before the work could run or while it was queued. Retrying is
    pointless: the caller's budget is spent."""


class ServiceCrashed(TransportError):
    """The service handler/thread died while a request was in flight —
    distinct from :class:`ResponseTimeout` so retry layers fail over
    immediately instead of waiting out the deadline."""


def _lanes(frame: torch.Tensor) -> tuple:
    """(absolute deadline or None, priority) of a verified frame."""
    words = frame[0, :framing.PRIORITY_LANE + 1].cpu().tolist()
    return (gateway.deadline_of(words[framing.DEADLINE_LANE]),
            words[framing.PRIORITY_LANE])


def serve_frame(frame: torch.Tensor, handler: Callable, *, seed: int,
                seq: int) -> torch.Tensor:
    """One request frame → one response frame on the same device.

    Raises :class:`framing.FrameError` when the guard refuses the frame,
    :class:`DeadlineExpired` when its propagated deadline has passed before
    execution, and whatever typed error the handler raises."""
    req = framing.verify_view(frame, seed=seed, expect_seq=seq)
    deadline, priority = _lanes(frame)
    if deadline is not None and time.monotonic() >= deadline:
        raise DeadlineExpired("propagated deadline expired before execution")
    prev = gateway.push_context(deadline, priority)
    try:
        resp = handler(req)
    finally:
        gateway.pop_context(prev)
    return framing.build_frame(resp, seed=seed, seq=seq, device=frame.device)


def serve_batch(frames: Union[torch.Tensor, Sequence[torch.Tensor]],
                batch_handler: Callable, *, seed: int,
                seqs: Sequence[int]) -> List[Union[torch.Tensor, BaseException]]:
    """A batch envelope (a row-concatenation of frames, or a list of them)
    → one response frame or typed error per item, in order.

    Frames the guard refuses keep their ``FrameError``; expired items get
    :class:`DeadlineExpired`; the rest go to ``batch_handler`` in one call
    under the cohort's tightest deadline and most urgent priority, and
    their responses are sealed with one ``seal_batch``. A handler failure
    becomes every executed item's error."""
    if isinstance(frames, torch.Tensor):
        frames = framing.split_frames(frames)
    results: List[Union[torch.Tensor, BaseException, None]] = list(
        framing.verify_batch(frames, seed=seed, seqs=seqs, strict=False))
    now = time.monotonic()
    good, deadlines, priorities = [], [], []
    for i, p in enumerate(results):
        if isinstance(p, framing.FrameError):
            continue
        deadline, priority = _lanes(frames[i])
        if deadline is not None and now >= deadline:
            results[i] = DeadlineExpired(
                "propagated deadline expired before execution")
            continue
        good.append(i)
        if deadline is not None:
            deadlines.append(deadline)
        priorities.append(priority)
    if not good:
        return results
    prev = gateway.push_context(min(deadlines) if deadlines else None,
                                min(priorities, key=gateway.priority_rank))
    try:
        outs = batch_handler([results[i] for i in good])
        if len(outs) != len(good):
            raise TransportError(f"batch handler returned {len(outs)} "
                                 f"responses for {len(good)} requests")
    except Exception as e:          # every executed item carries the error
        for i in good:
            results[i] = e
        return results
    finally:
        gateway.pop_context(prev)
    sealable = [(i, o) for i, o in zip(good, outs)
                if not isinstance(o, BaseException)]
    for i, o in zip(good, outs):
        if isinstance(o, BaseException):
            results[i] = o
    sealed = framing.seal_batch([o for _, o in sealable], seed=seed,
                                seqs=[seqs[i] for i, _ in sealable],
                                device=frames[0].device)
    for (i, _), f in zip(sealable, sealed):
        results[i] = f
    return results
