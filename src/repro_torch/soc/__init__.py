"""``repro_torch.soc`` — the Synergy SoC execution layer (paper §4.3).

Where :mod:`repro_torch.engines` answers "*which* engine should run this
JobSet", this package answers "*run it*": a live work-stealing runtime
(:class:`SynergyRuntime`) with one worker per engine and per-engine job
deques, the shared steal policy (:mod:`repro_torch.soc.policy`) the
discrete-event simulator applies, and a virtual-time conformance twin
(:class:`SimRuntime`) so simulated and live steal decisions agree for
identical cost models.

    from repro_torch.soc import SynergyRuntime, runtime_scope

    with SynergyRuntime(["cuda-tiled", "neon-vpu"]) as rt, rt.scope():
        y = synergy_matmul(a, b)      # row panels split across BOTH kernels
    print(rt.stats()["total_steals"])

Dataflow graphs (:mod:`repro_torch.soc.graph`) go through
``SynergyRuntime.submit_graph``.  Durable serving — the request journal,
crash plans, snapshot loading and the SIGTERM drain — is
:mod:`repro_torch.soc.durable`.
"""

from .durable import (CrashPlan, Durability, RequestJournal,
                      RestoreMismatch, SimulatedCrash,
                      install_sigterm_drain, install_sigterm_handler)
from .faults import (FAULT_KINDS, CorruptOutput, DroppedCompletion,
                     FaultPlan, FaultSpec, FaultyEngine, InjectedFault,
                     PanelRetryExhausted, RetryPolicy, WorkerKilled,
                     wrap_pool)
from .graph import GraphCancelled, GraphFuture, GraphNode
from .policy import (STEAL_QUEUE_DEPTH, STEAL_RATE_FLOOR, lpt_pick,
                     pick_victim, should_steal)
from .qos import (AdmissionRejected, EngineHealth, HealthPolicy, Tenant)
from .qos_policy import (BEST_EFFORT, BULK, DEFAULT_CLASS, INTERACTIVE,
                         NEUTRAL_TAG, FairShare, QosClass, QosTag,
                         effective_deadline, qos_victim, queue_insert_index)
from .runtime import (RuntimeFuture, SynergyRuntime, current_runtime,
                      runtime_scope)
from .simrt import (SimGraphResult, SimQosResult, SimRuntime,
                    SimRuntimeResult)

__all__ = [
    "SynergyRuntime", "RuntimeFuture", "runtime_scope", "current_runtime",
    "SimRuntime", "SimRuntimeResult", "SimGraphResult", "SimQosResult",
    "GraphNode", "GraphFuture", "GraphCancelled",
    "should_steal", "pick_victim", "lpt_pick",
    "STEAL_RATE_FLOOR", "STEAL_QUEUE_DEPTH",
    "QosClass", "QosTag", "NEUTRAL_TAG", "DEFAULT_CLASS", "INTERACTIVE",
    "BULK", "BEST_EFFORT", "FairShare", "effective_deadline",
    "qos_victim", "queue_insert_index",
    "Tenant", "AdmissionRejected", "HealthPolicy", "EngineHealth",
    "FAULT_KINDS", "FaultPlan", "FaultSpec", "FaultyEngine", "RetryPolicy",
    "InjectedFault", "CorruptOutput", "WorkerKilled", "DroppedCompletion",
    "PanelRetryExhausted", "wrap_pool",
    "Durability", "RequestJournal", "CrashPlan", "SimulatedCrash",
    "RestoreMismatch", "install_sigterm_handler", "install_sigterm_drain",
]
