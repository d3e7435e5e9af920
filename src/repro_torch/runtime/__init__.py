"""repro_torch.runtime — the heartbeat failure detector that
:class:`repro_torch.soc.SynergyRuntime`'s fault-recovery monitor ticks
(:mod:`repro_torch.runtime.fault_tolerance`)."""

from .fault_tolerance import (FailureEvent, HeartbeatMonitor,
                              plan_elastic_mesh, run_with_recovery)

__all__ = ["HeartbeatMonitor", "FailureEvent", "run_with_recovery",
           "plan_elastic_mesh"]
