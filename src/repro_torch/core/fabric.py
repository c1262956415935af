"""MPKLinkFabric: the paper's protected channels between ranks (the port of
``repro.core.fabric`` over ``torch.distributed``).

The reference lowers each channel to a JAX collective inside
``shard_map``; here every function is called in every rank of the
channel's group, on that rank's local tensor, as the reference's bodies
are called on each device's shard. A channel spans one dimension of a
``DeviceMesh`` and uses its process group: the axis size is the group's
size, the axis index the rank within it, and ``ppermute`` is a batch of
``isend`` / ``irecv`` to and from the two neighbours. The three properties
of the reference carry over:

1. **Establishment before use.** A channel is created once through the CA
   (enrolled endpoints, a domain, keys). Using it without its key raises
   ``AccessViolation`` in every rank before any exchange is issued (the
   PKRU analogue), so no rank waits for a peer that refused.
2. **Guarded transfer.** With ``guard`` on, every hop carries the MAC of
   its payload under the channel's seed (domain tag ⊕ epoch), and the
   receiver recomputes it: ``ok`` is an int32 tensor on the payload's
   device, 1 when every hop's MAC matched. The runtime reads it
   (``runtime.fault``'s guard trips); nothing here syncs the host for it.
   A MAC is ``kernels.ops.mac_batch`` on a stack of one frame: one launch
   of the hand-written kernel on CUDA tensors, whose blocks split a long
   frame's rows between them (the streaming trio would take three
   launches a hop for the same words), its plain version on the CPU.
3. **An explicit sync schedule.** The ring collectives are chains of
   neighbour exchanges, so the hops a step takes are counted
   (:data:`FABRIC_STATS`), not left to a library.

**Staging.** NCCL needs a card per rank. Where a channel's group runs
gloo and the tensor lies on a card (one card shared by every rank), each
exchange goes through pinned host buffers: device → host copies, the
gloo exchange, host → device copies. That is the designed path on one
card; :data:`FABRIC_STATS` counts the staged bytes. On a group whose
backend is NCCL the tensors go as they are.

``neighbor_exchange`` and ``all_to_all`` are differentiable: the backward
of a shift is the opposite shift, the backward of an all-to-all the
all-to-all with split and concat swapped, as JAX transposes ``ppermute``
and ``all_to_all`` (the backward hops carry no MAC, as in the
reference). ``ring_all_gather`` and ``reduce_scatter_ring`` are built of
them. ``psum_guarded`` has no backward and refuses inputs that require
grad.
"""
from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.ca import CertificateAuthority, enroll
from repro_torch.core.domains import (AccessViolation, DomainKey, KeyRegistry,
                                      ProtectionDomain, RW, mac_seed)
from repro_torch.kernels import ops

LANES = 128


# ---------------------------------------------------------------------------
# channel establishment (host side)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FabricChannel:
    name: str
    axis: str                  # mesh dimension the channel spans
    domain: ProtectionDomain
    epoch: int
    guard: bool                # MAC verification on every hop
    tag: int                   # the MAC tag, the same in every rank

    @property
    def seed(self) -> int:
        return mac_seed(replace(self.domain, tag=self.tag), self.epoch)


def channel_tag(name: str, axis: str, did: int) -> int:
    """The channel's MAC tag: a CRC of its name, axis and key number, so
    that every rank derives the same one. (A domain's own tag comes from
    Python's string hash, which differs between processes: the reference
    runs every device in one process, the port a process a rank.)"""
    return zlib.crc32(f"{name}@{axis}#{did}".encode()) | 1


class MPKLinkFabric:
    """Channels over the dimensions of ``mesh`` (a ``DeviceMesh``; None:
    every channel spans the default group). Every rank builds its own
    fabric and establishes the same channels in the same order, so the
    domains, epochs and seeds agree across ranks."""

    def __init__(self, mesh=None, *, guard: bool = False, max_channels: int = 64):
        self.mesh = mesh
        self.guard = guard
        # the card has no 16-domain limit: allow more channels
        self.registry = KeyRegistry(max_keys=max_channels)
        self.ca = CertificateAuthority(self.registry)
        self._keys: Dict[Tuple[str, str], DomainKey] = {}

    def establish(self, name: str, axis: str,
                  guard: Optional[bool] = None) -> Tuple[FabricChannel, DomainKey]:
        """A CA-verified channel over a mesh dimension → (channel, key)."""
        a, b = f"{name}@{axis}:even", f"{name}@{axis}:odd"
        enroll(self.ca, a)
        enroll(self.ca, b)
        dom, key, _ = self.ca.grant_channel(a, b, RW)
        chan = FabricChannel(name, axis, dom, self.registry.epoch(dom),
                             self.guard if guard is None else guard,
                             channel_tag(name, axis, dom.did))
        self._keys[(name, axis)] = key
        return chan, key

    def check(self, chan: FabricChannel, key: DomainKey, rights: int = RW):
        """The capability check every use of a channel makes first."""
        self.registry.check(key, rights)
        if key.domain != chan.domain:
            raise AccessViolation(
                f"key for domain {key.domain.name} used on channel {chan.name}")

    def revoke(self, chan: FabricChannel):
        key = self._keys.pop((chan.name, chan.axis), None)
        if key is not None:
            self.registry.revoke(key)

    def group(self, chan: FabricChannel):
        """The process group of the channel's mesh dimension."""
        if self.mesh is None:
            return dist.group.WORLD
        return self.mesh.get_group(chan.axis)


def axis_size(group) -> int:
    """The size of a channel's group (the reference's ``axis_size``)."""
    return dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's place in a channel's group (``jax.lax.axis_index``)."""
    return dist.get_rank(group)


# ---------------------------------------------------------------------------
# exchanges: point to point and collective, staged through the host on gloo
# ---------------------------------------------------------------------------

class FabricStats:
    """Counters of the fabric's traffic in this process: ``hops`` (point-to-
    point batches), ``collectives`` (all-reduces and all-gathers),
    ``sent_bytes`` (payload bytes this rank sent) and ``staged_bytes``
    (bytes copied between the card and pinned host buffers, both ways)."""

    KEYS = ("hops", "collectives", "sent_bytes", "staged_bytes")

    def __init__(self):
        self._lock = threading.Lock()
        self._n = dict.fromkeys(self.KEYS, 0)

    def add(self, **counts: int) -> None:
        with self._lock:
            for k, v in counts.items():
                self._n[k] += v

    def reset(self) -> None:
        with self._lock:
            self._n = dict.fromkeys(self.KEYS, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)


FABRIC_STATS = FabricStats()


def _staged(t: torch.Tensor, group) -> bool:
    """True when ``t`` lies on a card and the group's backend is not NCCL:
    gloo then exchanges pinned host copies."""
    return t.is_cuda and "nccl" not in str(dist.get_backend(group))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _to_host(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pinned host copies of card tensors, complete when this returns."""
    hosts = [_pinned_like(t) for t in ts]
    for h, t in zip(hosts, ts):
        h.copy_(t, non_blocking=True)
    if ts:
        torch.cuda.current_stream(ts[0].device).synchronize()
    FABRIC_STATS.add(staged_bytes=sum(t.nbytes for t in ts))
    return hosts


def _from_host(outs: Sequence[torch.Tensor], hosts: Sequence[torch.Tensor]):
    for o, h in zip(outs, hosts):
        o.copy_(h, non_blocking=True)
    FABRIC_STATS.add(staged_bytes=sum(o.nbytes for o in outs))


def _p2p(group, sends: Sequence[Tuple[int, torch.Tensor]],
         recvs: Sequence[Tuple[int, torch.Tensor]]) -> None:
    """One batch of point-to-point transfers within ``group``: each
    (peer, tensor) of ``sends`` goes to that peer (a rank of the group),
    each of ``recvs`` is filled from its peer. Tensors are contiguous;
    the i-th transfer between two ranks uses tag i, so several to one peer
    pair up in order."""
    if not sends and not recvs:
        return
    staged = any(_staged(t, group) for _, t in (*sends, *recvs))
    s_bufs = [t for _, t in sends]
    r_bufs = [t for _, t in recvs]
    if staged:
        s_bufs = _to_host(s_bufs)
        r_bufs = [_pinned_like(t) for t in r_bufs]
    ops_: list = []
    tags: Dict[Tuple[str, int], int] = {}
    for kind, fn, items, bufs in (("s", dist.isend, sends, s_bufs),
                                  ("r", dist.irecv, recvs, r_bufs)):
        for (peer, _), buf in zip(items, bufs):
            tag = tags.get((kind, peer), 0)
            tags[(kind, peer)] = tag + 1
            ops_.append(dist.P2POp(fn, _bytes(buf),
                                   dist.get_global_rank(group, peer), group,
                                   tag=tag))
    for work in dist.batch_isend_irecv(ops_):
        work.wait()
    if staged:
        _from_host([t for _, t in recvs], r_bufs)
    FABRIC_STATS.add(hops=1, sent_bytes=sum(t.nbytes for _, t in sends))


def _ppermute(ts: Sequence[torch.Tensor], group, shift: int) -> List[torch.Tensor]:
    """``jax.lax.ppermute`` by ``shift`` around the group's ring: rank i
    sends each tensor to i + shift and receives from i − shift."""
    n, i = axis_size(group), axis_index(group)
    ts = [t.contiguous() for t in ts]
    if shift % n == 0:
        return [t.clone() for t in ts]
    outs = [torch.empty_like(t) for t in ts]
    _p2p(group, [((i + shift) % n, t) for t in ts],
         [((i - shift) % n, o) for o in outs])
    return outs


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over the group → a new tensor."""
    t = t.contiguous().clone()
    buf = _to_host([t])[0] if _staged(t, group) else t
    dist.all_reduce(buf, group=group)
    if buf is not t:
        _from_host([t], [buf])
    FABRIC_STATS.add(collectives=1, sent_bytes=t.nbytes)
    return t


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t``, by rank in the group."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(axis_size(group))]
    if _staged(t, group):
        bufs = [_pinned_like(t) for _ in outs]
        dist.all_gather(bufs, _to_host([t])[0], group=group)
        _from_host(outs, bufs)
    else:
        dist.all_gather(outs, t, group=group)
    FABRIC_STATS.add(collectives=1, sent_bytes=t.nbytes)
    return outs


# ---------------------------------------------------------------------------
# on-device guard (MAC attach / verify)
# ---------------------------------------------------------------------------

def _as_u32_rows(x: torch.Tensor) -> torch.Tensor:
    """x's bits as (rows, 128) uint32, zero-padded (little-endian words:
    two 16-bit elements a word, an 8-byte element as its low word then its
    high word, as the reference bitcasts them)."""
    flat = x.detach().reshape(-1)
    size = flat.element_size()
    if size not in (2, 4, 8):
        raise ValueError(f"unsupported itemsize {size * 8}")
    n_words = -(-flat.numel() * size // 4)
    rows = -(-n_words // LANES)
    if (n_words == rows * LANES and flat.numel() * size == n_words * 4
            and flat.data_ptr() % 16 == 0):
        return flat.view(torch.int32).view(rows, LANES).view(torch.uint32)
    u = torch.zeros(rows * LANES, dtype=torch.int32, device=x.device)
    u.view(torch.uint8)[:flat.numel() * size].copy_(flat.view(torch.uint8))
    return u.view(rows, LANES).view(torch.uint32)


def attach_mac(x: torch.Tensor, seed: int) -> torch.Tensor:
    """The MAC of x's bits under the channel seed → 0-d uint32 tensor on
    x's device (one ``mac_batch`` launch on a card)."""
    return ops.mac_batch(_as_u32_rows(x)[None], seed)[0]


def verify_mac(x: torch.Tensor, mac: torch.Tensor, seed: int) -> torch.Tensor:
    """→ ok flag, a 0-d int32 tensor on x's device: 1 when x's MAC under
    ``seed`` equals ``mac``."""
    got = attach_mac(x, seed).view(torch.int32)
    return (got == mac.to(x.device).view(torch.int32)).to(torch.int32)


# ---------------------------------------------------------------------------
# guarded collectives (called in every rank of the channel's group)
# ---------------------------------------------------------------------------

class _Shift(torch.autograd.Function):
    """ppermute of ``x`` (and of ``extra`` tensors in the same batch, which
    carry no gradient); the backward shifts the gradient back."""

    @staticmethod
    def forward(ctx, group, shift, x, *extra):
        ctx.group, ctx.shift = group, shift
        outs = _ppermute([x, *extra], group, shift)
        ctx.mark_non_differentiable(*outs[1:])
        return tuple(outs) if extra else outs[0]

    @staticmethod
    def backward(ctx, gy, *_):
        gx = _ppermute([gy], ctx.group, -ctx.shift)[0]
        return (None, None, gx) + (None,) * len(_)


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.int32, device=x.device)


def neighbor_exchange(fabric: MPKLinkFabric, chan: FabricChannel, key: DomainKey,
                      x: torch.Tensor, *, shift: int = 1):
    """Ring shift over the channel's group, after the capability check,
    with the MAC guard when the channel has it → (received, ok)."""
    fabric.check(chan, key)
    group = fabric.group(chan)
    if not chan.guard:
        return _Shift.apply(group, shift, x), _ones(x)
    mac = attach_mac(x, chan.seed).view(torch.int32).reshape(1)
    y, mac_y = _Shift.apply(group, shift, x, mac)
    return y, verify_mac(y, mac_y, chan.seed)


def ring_all_gather(fabric: MPKLinkFabric, chan: FabricChannel, key: DomainKey,
                    x: torch.Tensor, *, axis_index: Optional[int] = None):
    """All-gather along dim 0 built of n − 1 chained neighbour pushes (each
    a channel hop) → (gathered, ok)."""
    fabric.check(chan, key)
    group = fabric.group(chan)
    n = axis_size(group)
    idx = dist.get_rank(group) if axis_index is None else axis_index
    parts, cur, ok = [x], x, _ones(x)
    for _ in range(n - 1):
        cur, ok_i = neighbor_exchange(fabric, chan, key, cur, shift=1)
        parts.append(cur)
        ok = ok & ok_i
    # the piece of hop j came from rank (idx - j) mod n
    ordered = [parts[(idx - r) % n] for r in range(n)]
    return torch.cat(ordered, dim=0), ok


def reduce_scatter_ring(fabric: MPKLinkFabric, chan: FabricChannel, key: DomainKey,
                        x: torch.Tensor):
    """Ring reduce-scatter over dim 0 (divisible by the group's size): n − 1
    hops of one shard each → (this rank's summed shard, ok)."""
    fabric.check(chan, key)
    group = fabric.group(chan)
    n, idx = axis_size(group), axis_index(group)
    shards = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    acc, ok = torch.zeros_like(shards[0]), _ones(x)
    for j in range(n - 1):
        # push the partial of chunk idx-1-j; what arrives is the partial of
        # chunk idx-2-j, pushed next; after n-1 hops it is chunk idx summed
        # over every other rank
        acc, ok_i = neighbor_exchange(fabric, chan, key,
                                      shards[(idx - 1 - j) % n] + acc, shift=1)
        ok = ok & ok_i
    return shards[idx] + acc, ok


def _a2a(x: torch.Tensor, group, split_axis: int, concat_axis: int):
    n, i = axis_size(group), axis_index(group)
    chunks = [c.contiguous() for c in x.chunk(n, dim=split_axis)]
    outs = [torch.empty_like(c) for c in chunks]
    outs[i].copy_(chunks[i])
    peers = [p for p in range(n) if p != i]
    _p2p(group, [(p, chunks[p]) for p in peers], [(p, outs[p]) for p in peers])
    return torch.cat(outs, dim=concat_axis)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, group, split_axis, concat_axis, x):
        ctx.args = (group, split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, gy):
        group, split_axis, concat_axis = ctx.args
        return None, None, None, _a2a(gy.contiguous(), group, concat_axis,
                                      split_axis)


def all_to_all(fabric: MPKLinkFabric, chan: FabricChannel, key: DomainKey,
               x: torch.Tensor, *, split_axis: int, concat_axis: int):
    """The expert-parallel dispatch and return channel: ``x`` splits into n
    chunks along ``split_axis``, chunk j goes to rank j, and the chunks
    received concatenate along ``concat_axis`` by source rank (JAX's tiled
    ``all_to_all``)."""
    fabric.check(chan, key)
    group = fabric.group(chan)
    if x.shape[split_axis] % axis_size(group):
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {axis_size(group)} ranks")
    return _AllToAll.apply(group, split_axis, concat_axis, x)


def psum_guarded(fabric: MPKLinkFabric, chan: FabricChannel, key: DomainKey,
                 x: torch.Tensor):
    """Sum over the channel's group, after the capability check. It has no
    backward: an input that requires grad raises."""
    fabric.check(chan, key)
    if ops.needs_grad(x):
        raise RuntimeError("psum_guarded has no backward, and its input "
                           "requires grad")
    return _all_reduce(x, fabric.group(chan))
