"""MPKLink in the port: domains and keys (``domains``), identities and
channel grants (``ca``, ``signature``), frames and their MACs
(``framing``), the paper's IPC transport zoo (``transports``), its
word-count workload (``wordcount``) and the service gateway
(``gateway``: named services, clients, the coalescer, QoS and in-process
replica fleets).

``ALL_TRANSPORTS`` is what a gateway or a fleet resolves a transport name
against. In the reference it adds the process transports of ``procwire``
(``*_proc``) to ``TRANSPORTS``; the port has none yet (ROADMAP.md, queue
1, item 3), so the two are equal, and a ``*_proc`` name raises
``gateway.ProcTransportNotPorted``."""
from repro_torch.core import ca, domains, framing, gateway, signature, transports, wordcount
from repro_torch.core.domains import (AccessViolation, DomainKey, KeyRegistry,
                                      ProtectionDomain, READ, RW, WRITE, mac_seed)
from repro_torch.core.gateway import (CallCoalescer, GatewayClient, Replica,
                                      ReplicaRouter, ServiceFleet, ServiceGateway,
                                      ServiceHealth, simulate_assignments)

TRANSPORTS = {
    "pipe": transports.PipeTransport,
    "uds": transports.UDSTransport,
    "shm": transports.ShmTransport,
    "grpc_sim": transports.GrpcSimTransport,
    "mpklink": transports.MPKLinkTransport,
    "mpklink_opt": transports.MPKLinkOptTransport,
}
ALL_TRANSPORTS = dict(TRANSPORTS)

__all__ = ["ca", "domains", "framing", "gateway", "signature", "transports",
           "wordcount", "AccessViolation", "DomainKey", "KeyRegistry",
           "ProtectionDomain", "READ", "RW", "WRITE", "mac_seed", "TRANSPORTS",
           "ALL_TRANSPORTS", "CallCoalescer", "GatewayClient", "Replica",
           "ReplicaRouter", "ServiceFleet", "ServiceGateway", "ServiceHealth",
           "simulate_assignments"]
