"""The ported simulator core: workloads, priorities, protocols, the
leaf-spine fabric, the per-slot loop and the sweep engine."""
from repro_torch.core.sim import SimConfig, SimResult, run_sweep, simulate
from repro_torch.core.sweep import StreamSpec, SweepSpec, SweepStats
from repro_torch.core.fabric import FabricConfig
from repro_torch.core.protocols import (Protocol, SenderPolicy,
                                        ReceiverPolicy, register,
                                        get_protocol, registered_protocols)
from repro_torch.core.workloads import MessageTable, WorkloadSpec, \
    make_messages
from repro_torch.core.priorities import PriorityAllocation, \
    allocate_priorities

__all__ = [
    "SimConfig", "SimResult", "FabricConfig", "simulate", "run_sweep",
    "SweepSpec", "StreamSpec", "SweepStats",
    "Protocol", "SenderPolicy", "ReceiverPolicy", "register",
    "get_protocol", "registered_protocols",
    "MessageTable", "WorkloadSpec", "make_messages",
    "PriorityAllocation", "allocate_priorities",
]
