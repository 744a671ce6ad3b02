"""The ported simulator core: workloads, priorities, protocols, the
leaf-spine fabric and the per-slot loop."""
from repro_torch.core.sim import SimConfig, SimResult, simulate
from repro_torch.core.fabric import FabricConfig
from repro_torch.core.protocols import (Protocol, SenderPolicy,
                                        ReceiverPolicy, register,
                                        get_protocol, registered_protocols)
from repro_torch.core.workloads import MessageTable, WorkloadSpec, \
    make_messages
from repro_torch.core.priorities import PriorityAllocation, \
    allocate_priorities

__all__ = [
    "SimConfig", "SimResult", "FabricConfig", "simulate",
    "Protocol", "SenderPolicy", "ReceiverPolicy", "register",
    "get_protocol", "registered_protocols",
    "MessageTable", "WorkloadSpec", "make_messages",
    "PriorityAllocation", "allocate_priorities",
]
