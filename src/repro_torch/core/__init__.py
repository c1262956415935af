"""MPKLink in the port: domains and keys (``domains``), identities and
channel grants (``ca``, ``signature``), frames and their MACs
(``framing``), the paper's IPC transport zoo (``transports``), its
word-count workload (``wordcount``), the service gateway (``gateway``:
named services, clients, the coalescer, QoS, replica fleets and their
supervisor), the process transports and the REST / socket-RPC baselines
(``procwire``), the fault-injection fabric (``faultwire``), and the
device fabric between ranks (``fabric``: guarded channels and collectives
over ``torch.distributed``) with its sequence-parallel attention
(``ring_attention``).

``ALL_TRANSPORTS`` is what a gateway or a fleet resolves a transport name
against: the in-process ``TRANSPORTS`` plus ``procwire``'s
``PROC_TRANSPORTS`` (``*_proc``) and ``BASELINE_TRANSPORTS``."""
from repro_torch.core import ca, domains, framing, gateway, signature, transports, wordcount
from repro_torch.core.domains import (AccessViolation, DomainKey, KeyRegistry,
                                      ProtectionDomain, READ, RW, WRITE, mac_seed)
from repro_torch.core.gateway import (CallCoalescer, FleetSupervisor,
                                      GatewayClient, Replica, ReplicaRouter,
                                      ServiceFleet, ServiceGateway,
                                      ServiceHealth, simulate_assignments)

TRANSPORTS = {
    "pipe": transports.PipeTransport,
    "uds": transports.UDSTransport,
    "shm": transports.ShmTransport,
    "grpc_sim": transports.GrpcSimTransport,
    "mpklink": transports.MPKLinkTransport,
    "mpklink_opt": transports.MPKLinkOptTransport,
}

# process-backed transports and the REST / socket-RPC baselines, kept out
# of TRANSPORTS so the in-process matrix keeps its semantics
from repro_torch.core import procwire                # noqa: E402
from repro_torch.core.procwire import (BASELINE_TRANSPORTS,  # noqa: E402
                                       PROC_TRANSPORTS)

ALL_TRANSPORTS = {**TRANSPORTS, **PROC_TRANSPORTS, **BASELINE_TRANSPORTS}

from repro_torch.core import faultwire               # noqa: E402
from repro_torch.core.faultwire import (FaultFabric, FaultPlan,  # noqa: E402
                                        FaultyClient)
from repro_torch.core.transports import (ResponseTimeout,  # noqa: E402
                                         ServiceCrashed, ServiceUnavailable)
from repro_torch.core import fabric, ring_attention  # noqa: E402

__all__ = ["ca", "domains", "fabric", "framing", "gateway", "faultwire",
           "procwire", "ring_attention",
           "signature", "transports", "wordcount", "AccessViolation",
           "DomainKey", "KeyRegistry", "ProtectionDomain", "READ", "RW",
           "WRITE", "mac_seed", "TRANSPORTS", "PROC_TRANSPORTS",
           "BASELINE_TRANSPORTS", "ALL_TRANSPORTS", "CallCoalescer",
           "FleetSupervisor", "GatewayClient", "Replica", "ReplicaRouter",
           "ServiceFleet", "ServiceGateway", "ServiceHealth",
           "simulate_assignments", "FaultFabric", "FaultPlan", "FaultyClient",
           "ResponseTimeout", "ServiceCrashed", "ServiceUnavailable"]
