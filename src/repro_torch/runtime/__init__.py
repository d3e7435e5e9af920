"""repro_torch.runtime — the heartbeat failure detector that
:class:`repro_torch.soc.SynergyRuntime`'s fault-recovery monitor ticks
(:mod:`repro_torch.runtime.fault_tolerance`), the training supervisor
``run_with_recovery`` and the between-step straggler rebalancer
(:mod:`repro_torch.runtime.straggler`)."""

from .fault_tolerance import (FailureEvent, HeartbeatMonitor,
                              plan_elastic_mesh, run_with_recovery)
from .straggler import StragglerRebalancer

__all__ = ["HeartbeatMonitor", "FailureEvent", "run_with_recovery",
           "plan_elastic_mesh", "StragglerRebalancer"]
