"""Service identity + message authentication for MPKLink (the port of
``repro.core.signature``, copied as it is).

Two layers, mirroring the paper §V:

1. **Service key pairs / CA signatures** (control plane, host Python):
   every microservice registers a public/private key pair with the CA.
   We implement a deterministic Schnorr-style scheme over the multiplicative
   group mod a 61-bit Mersenne prime — NOT cryptographically strong (no
   crypto libs in this container; the paper's artifact likewise used a dev
   scheme), but structurally faithful: sign/verify asymmetry, unforgeability
   against the toy adversary in tests, and the exact CA handshake flow.

2. **Per-message MACs** (data plane, on the device where the frame lies):
   the Horner-hash MAC of kernels/mpk_guard.py, seeded by domain tag ⊕
   epoch ⊕ a session key derived from BOTH endpoints' identities during
   channel establishment.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple

P = (1 << 61) - 1          # Mersenne prime 2^61-1
G = 5                       # generator (good enough for the toy group)


def _h(*parts) -> int:
    m = hashlib.sha256()
    for p in parts:
        m.update(str(p).encode())
        m.update(b"|")
    return int.from_bytes(m.digest()[:8], "big") % (P - 1)


@dataclass(frozen=True)
class KeyPair:
    private: int
    public: int

    @staticmethod
    def generate(seed: str) -> "KeyPair":
        priv = _h("priv", seed) or 1
        return KeyPair(priv, pow(G, priv, P))


def sign(priv: int, message: bytes) -> Tuple[int, int]:
    """Deterministic Schnorr: k = H(priv, msg); r = g^k; s = k + H(r, msg)·priv."""
    k = _h("k", priv, message) or 1
    r = pow(G, k, P)
    e = _h("e", r, message)
    s = (k + e * priv) % (P - 1)
    return r, s


def verify(pub: int, message: bytes, sig: Tuple[int, int]) -> bool:
    r, s = sig
    e = _h("e", r, message)
    # g^s == r · pub^e
    return pow(G, s, P) == (r * pow(pub, e, P)) % P


def session_key(priv_a: int, pub_b: int) -> int:
    """Diffie-Hellman shared secret → 32-bit MAC session seed."""
    shared = pow(pub_b, priv_a, P)
    return _h("sess", shared) & 0xFFFFFFFF
