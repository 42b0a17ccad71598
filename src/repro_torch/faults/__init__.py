"""Clock-driven fault injection and failover primitives.

Import-light by design, as in the reference: the sharded data plane's
cache client (:mod:`repro_torch.service`) wires a
:class:`LivenessRegistry` without dragging in ``repro_torch.workload`` —
see the module docstrings.
"""
from repro_torch.faults.injector import FaultInjector, corrupt_spill_files
from repro_torch.faults.liveness import LivenessRegistry
from repro_torch.faults.spec import FAULT_KINDS, FaultSpec

__all__ = [
    "FAULT_KINDS",
    "FaultInjector",
    "FaultSpec",
    "LivenessRegistry",
    "corrupt_spill_files",
]
