"""MPKLink in the port: domains and keys (``domains``), identities and
channel grants (``ca``, ``signature``), frames and their MACs
(``framing``), the paper's IPC transport zoo (``transports``), its
word-count workload (``wordcount``) and the per-request context
(``gateway``)."""
from repro_torch.core import ca, domains, framing, gateway, signature, transports, wordcount
from repro_torch.core.domains import (AccessViolation, DomainKey, KeyRegistry,
                                      ProtectionDomain, READ, RW, WRITE, mac_seed)

TRANSPORTS = {
    "pipe": transports.PipeTransport,
    "uds": transports.UDSTransport,
    "shm": transports.ShmTransport,
    "grpc_sim": transports.GrpcSimTransport,
    "mpklink": transports.MPKLinkTransport,
    "mpklink_opt": transports.MPKLinkOptTransport,
}

__all__ = ["ca", "domains", "framing", "gateway", "signature", "transports",
           "wordcount", "AccessViolation", "DomainKey", "KeyRegistry",
           "ProtectionDomain", "READ", "RW", "WRITE", "mac_seed", "TRANSPORTS"]
