"""MPKLink as Certificate Authority (paper §V; the port of ``repro.core.ca``).

Each microservice registers a unique public/private key pair; MPKLink-as-CA
verifies digital signatures before a service may join a channel, so
"malicious or unverified microservices are incapable of tampering with
protected memory regions". Channel grants bind (service_a, service_b,
domain) and derive the data-plane MAC session seed from both identities.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core import signature as sig
from repro_torch.core.domains import (DomainKey, KeyRegistry,
                                      ProtectionDomain, RW, AccessViolation)


@dataclass
class ServiceRecord:
    name: str
    public_key: int
    cert: Tuple[int, int]          # CA signature over (name, public_key)
    verified: bool = True


class CertificateAuthority:
    """Registry of services + issuer of channel grants.

    Thread-safe: sessions enroll lazily from whatever thread first uses a
    client, so registration (which scans every record for the alias-refusal
    check) must not race concurrent inserts."""

    def __init__(self, registry: Optional[KeyRegistry] = None, seed: str = "mpklink-ca"):
        self.registry = registry or KeyRegistry()
        self._ca_keys = sig.KeyPair.generate(seed)
        self._services: Dict[str, ServiceRecord] = {}
        self._lock = threading.RLock()

    # -- service lifecycle ----------------------------------------------------
    def register(self, name: str, public_key: int, proof: Tuple[int, int]) -> ServiceRecord:
        """A service proves possession of its private key by signing its own
        registration; the CA then certifies (name, public_key). A revoked
        identity stays revoked: re-registration under the same name is
        refused, otherwise a ban would be one reconnect deep. Keys bind to
        exactly one identity: a (possibly stolen) key already certified for
        another name — revoked or not — cannot mint a fresh identity, so a
        banned client cannot re-enter under an alias."""
        with self._lock:
            existing = self._services.get(name)
            if existing is not None and not existing.verified:
                raise AccessViolation(
                    f"service {name}: identity revoked — re-registration refused")
            if existing is not None and existing.public_key != public_key:
                raise AccessViolation(
                    f"service {name}: name already bound to a different key — "
                    f"identity takeover refused")
            for rec in self._services.values():
                if rec.public_key == public_key and rec.name != name:
                    raise AccessViolation(
                        f"service {name}: key already bound to identity "
                        f"{rec.name!r}"
                        + (" (revoked)" if not rec.verified else "")
                        + " — alias registration refused")
            msg = f"register:{name}:{public_key}".encode()
            if not sig.verify(public_key, msg, proof):
                raise AccessViolation(f"service {name}: bad proof of possession")
            cert = sig.sign(self._ca_keys.private,
                            f"cert:{name}:{public_key}".encode())
            rec = ServiceRecord(name, public_key, cert)
            self._services[name] = rec
            return rec

    def verify_cert(self, rec: ServiceRecord) -> bool:
        msg = f"cert:{rec.name}:{rec.public_key}".encode()
        return sig.verify(self._ca_keys.public, msg, rec.cert)

    def revoke_service(self, name: str):
        with self._lock:
            if name in self._services:
                self._services[name].verified = False

    # -- channel grants ---------------------------------------------------------
    def grant_channel(self, svc_a: str, svc_b: str,
                      rights: int = RW) -> Tuple[ProtectionDomain, DomainKey, DomainKey]:
        """Both endpoints must be registered, verified, cert-valid. Returns the
        shared domain + one capability key per endpoint."""
        with self._lock:
            for name in (svc_a, svc_b):
                rec = self._services.get(name)
                if rec is None:
                    raise AccessViolation(
                        f"service {name} not registered with CA")
                if not rec.verified or not self.verify_cert(rec):
                    raise AccessViolation(
                        f"service {name} failed certificate check")
        dom = self.registry.allocate_domain(f"chan:{svc_a}<->{svc_b}")
        return dom, self.registry.issue_key(dom, rights), self.registry.issue_key(dom, rights)

    def session_seed(self, svc_a_priv: int, svc_b: str) -> int:
        """Data-plane MAC seed derived from both endpoint identities."""
        rec = self._services[svc_b]
        return sig.session_key(svc_a_priv, rec.public_key)


def enroll(ca: CertificateAuthority, name: str) -> Tuple[sig.KeyPair, ServiceRecord]:
    """Convenience: generate a key pair, prove possession, register."""
    kp = sig.KeyPair.generate(name)
    proof = sig.sign(kp.private, f"register:{name}:{kp.public}".encode())
    return kp, ca.register(name, kp.public, proof)
