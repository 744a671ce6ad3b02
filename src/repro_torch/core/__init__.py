"""The ported simulator core: workloads and scenarios, priorities,
protocols, the leaf-spine fabric with its fault layer, the host/NIC
stage, in-loop telemetry, the per-slot loop and the sweep engine."""
from repro_torch.core.sim import (SimConfig, SimResult, run_sweep, simulate,
                                  slowdown_percentiles)
from repro_torch.core.sweep import StreamSpec, SweepSpec, SweepStats
from repro_torch.core.fabric import FabricConfig
from repro_torch.core.faults import FaultConfig
from repro_torch.core.hostmodel import (HOST_PRESETS, CpuHostModel,
                                        HostConfig, HostModel,
                                        get_host_model, host_preset,
                                        register_host_model)
from repro_torch.core.telemetry import SimTrace, TraceConfig
from repro_torch.core.protocols import (Protocol, SenderPolicy,
                                        ReceiverPolicy, register,
                                        get_protocol, registered_protocols)
from repro_torch.core.workloads import MessageTable, WorkloadSpec, \
    make_messages
from repro_torch.core import scenarios
from repro_torch.core.priorities import PriorityAllocation, \
    allocate_priorities

__all__ = [
    "SimConfig", "SimResult", "FabricConfig", "FaultConfig", "simulate",
    "HostConfig", "HostModel", "CpuHostModel", "HOST_PRESETS",
    "host_preset", "register_host_model", "get_host_model",
    "TraceConfig", "SimTrace",
    "run_sweep", "SweepSpec", "StreamSpec", "SweepStats",
    "slowdown_percentiles",
    "Protocol", "SenderPolicy", "ReceiverPolicy", "register",
    "get_protocol", "registered_protocols",
    "MessageTable", "WorkloadSpec", "make_messages", "scenarios",
    "PriorityAllocation", "allocate_priorities",
]
