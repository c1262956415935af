"""Protection domains — the software pkey/PKRU layer (the port of
``repro.core.domains``, copied as it is: pure Python, no device).

Intel MPK gives 16 protection keys; a page is tagged with one key and each
thread's PKRU register holds a 2-bit (AD/WD) access field per key, switchable
without a syscall. This module is the staging-time analogue:

* ``ProtectionDomain``  — a pkey: an identity (id 0..15 by default, the x86
  limit, configurable) plus a 32-bit tag word that seeds the data-plane MAC.
* ``DomainKey``         — an unforgeable capability handle to a domain with a
  rights mask (READ/WRITE). Holding the key is the PKRU grant.
* ``KeyRegistry``       — the per-"process" key table: allocates domains,
  issues/revokes keys, and *checks* accesses. The transports check on the
  host before they touch a region, and the card has no MPK of its own, so
  a check is a staging-time capability test, not a hardware fault.
* ``pkru_word()``       — packs the registry's current grants into one
  integer exactly like the PKRU register layout (2 bits per key), used by
  the CPU transports to emulate the paper's key-synchronization traffic.

Revocation is epoch-based: revoking a key bumps the domain epoch; messages
framed under an old epoch fail the guard-kernel MAC check (core/framing.py
mixes the epoch into the MAC seed) — the analogue of flushing stale PKRU
state from other threads.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

READ = 0x1
WRITE = 0x2
RW = READ | WRITE

_PKRU_BITS = {0: 0b11, READ: 0b10, WRITE: 0b01, RW: 0b00}
# PKRU semantics: bit0 = access-disable, bit1 = write-disable (0 = allowed)


class AccessViolation(PermissionError):
    """Raised at staging time when a capability check fails."""


@dataclass(frozen=True)
class ProtectionDomain:
    did: int                    # pkey number
    name: str
    tag: int                    # 32-bit tag word fused into the MAC seed

    def __post_init__(self):
        assert 0 <= self.tag < 2 ** 32


@dataclass(frozen=True)
class DomainKey:
    """Capability handle. Unforgeable by construction: only KeyRegistry
    creates these (the nonce is private to the registry)."""
    domain: ProtectionDomain
    rights: int
    nonce: int
    epoch: int

    def allows(self, rights: int) -> bool:
        return (self.rights & rights) == rights


class KeyRegistry:
    """Allocates protection domains and issues capability keys.

    ``max_keys`` defaults to 16 (the x86 MPK limit) so resource exhaustion
    behaves like real hardware; pass a larger value for fabrics that need
    more channels (documented deviation — the emulation has no hardware key
    file).
    """

    def __init__(self, max_keys: int = 16, seed: int = 0x5EED):
        self._max = max_keys
        self._lock = threading.Lock()
        self._domains: Dict[int, ProtectionDomain] = {}
        self._epochs: Dict[int, int] = {}
        self._issued: Dict[int, set] = {}
        self._rng = itertools.count(seed * 2654435761 % 2 ** 31 + 1)
        self._next_id = 0
        self._free: list = []          # freed pkey numbers, reused like pkey_alloc

    # -- domains ------------------------------------------------------------
    def allocate_domain(self, name: str) -> ProtectionDomain:
        with self._lock:
            if self._free:
                did = self._free.pop()
            elif self._next_id < self._max:
                did = self._next_id
                self._next_id += 1
            else:
                raise ResourceWarning(
                    f"out of protection keys ({self._max}) — like pkey_alloc(2) "
                    f"returning ENOSPC")
            tag = (hash((name, did, 0x9E3779B9)) & 0xFFFFFFFF) | 1
            dom = ProtectionDomain(did, name, tag)
            self._domains[did] = dom
            self._epochs[did] = 0
            self._issued[did] = set()
            return dom

    def free_domain(self, dom: ProtectionDomain):
        with self._lock:
            if self._domains.pop(dom.did, None) is not None:
                self._free.append(dom.did)
            self._issued.pop(dom.did, None)
            self._epochs.pop(dom.did, None)

    # -- keys ---------------------------------------------------------------
    def issue_key(self, dom: ProtectionDomain, rights: int = RW) -> DomainKey:
        with self._lock:
            if dom.did not in self._domains:
                raise AccessViolation(f"domain {dom.name} not allocated here")
            nonce = next(self._rng)
            key = DomainKey(dom, rights, nonce, self._epochs[dom.did])
            self._issued[dom.did].add(nonce)
            return key

    def revoke(self, key: DomainKey):
        """Revoke one key and bump the domain epoch (stale frames fail MAC)."""
        with self._lock:
            self._issued.get(key.domain.did, set()).discard(key.nonce)
            if key.domain.did in self._epochs:
                self._epochs[key.domain.did] += 1

    def retire(self, key: DomainKey):
        """Graceful release: forget the nonce WITHOUT bumping the epoch.
        Closing a session is not a security event — other holders of keys
        on the domain keep working; the retired key itself stops checking."""
        with self._lock:
            self._issued.get(key.domain.did, set()).discard(key.nonce)

    def epoch(self, dom: ProtectionDomain) -> int:
        return self._epochs.get(dom.did, -1)

    # -- checks (staging-time PKRU) ------------------------------------------
    def check(self, key: DomainKey, rights: int):
        """The PKRU check. Raises AccessViolation on any failure mode the
        paper's threat model cares about: forged key, revoked key, stale
        epoch, insufficient rights."""
        with self._lock:
            dom = self._domains.get(key.domain.did)
            if dom is None or dom != key.domain:
                raise AccessViolation(f"unknown/forged domain {key.domain}")
            if key.nonce not in self._issued[dom.did]:
                raise AccessViolation(f"revoked or foreign key for {dom.name}")
            if key.epoch != self._epochs[dom.did]:
                raise AccessViolation(
                    f"stale key epoch {key.epoch} != {self._epochs[dom.did]} "
                    f"for {dom.name}")
            if not key.allows(rights):
                raise AccessViolation(
                    f"rights {rights:#x} not granted on {dom.name} "
                    f"(have {key.rights:#x})")

    # -- PKRU emulation for the CPU transports --------------------------------
    def pkru_word(self, keys: Tuple[DomainKey, ...]) -> int:
        """Pack grants into a PKRU-layout word (2 bits/key, 0b11 = no access)."""
        word = 0
        rights_by_did = {}
        for k in keys:
            rights_by_did[k.domain.did] = rights_by_did.get(k.domain.did, 0) | k.rights
        for did in range(self._max if self._max <= 16 else 16):
            bits = _PKRU_BITS[rights_by_did.get(did, 0)]
            word |= bits << (2 * did)
        return word


def mac_seed(dom: ProtectionDomain, epoch: int) -> int:
    """Tag ⊕ epoch mix fed to the guard kernel — stale epochs change the MAC."""
    return (dom.tag ^ (epoch * 0x85EBCA6B)) & 0xFFFFFFFF
