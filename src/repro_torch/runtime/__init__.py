"""repro_torch.runtime — the heartbeat failure detector that
:class:`repro_torch.soc.SynergyRuntime`'s fault-recovery monitor ticks
(:mod:`repro_torch.runtime.fault_tolerance`), the training supervisor
``run_with_recovery``, the between-step straggler rebalancer
(:mod:`repro_torch.runtime.straggler`) and the cross-pod local-SGD
synchronizer (:mod:`repro_torch.runtime.local_sgd`)."""

from .fault_tolerance import (FailureEvent, HeartbeatMonitor,
                              plan_elastic_mesh, run_with_recovery)
from .straggler import StragglerRebalancer
from .local_sgd import crosspod_traffic_bytes, sync_pods_compressed

__all__ = ["HeartbeatMonitor", "FailureEvent", "run_with_recovery",
           "plan_elastic_mesh", "StragglerRebalancer",
           "sync_pods_compressed", "crosspod_traffic_bytes"]
