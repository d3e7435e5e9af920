"""``repro_torch.engines`` — the unified accelerator abstraction (paper §3).

One registry, one dispatch surface, every backend:

    from repro_torch.engines import Engine, CostModel, register_engine

    class MyEngine(Engine):
        def __init__(self):
            super().__init__("mine", {"gemm", "epilogue"},
                             cost=CostModel(macs_per_s=1e12))
        def execute(self, a, b, *, bias=None, activation=None, **kw):
            ...

    register_engine(MyEngine())   # every GEMM call site can now route here

Importing this package registers the built-in engines (``torch``,
``cuda-tiled``, ``reference``) and the calibrated simulated Zynq PEs
(``F-PE``, ``S-PE``, ``NEON``, ``ARM``) exactly once.
"""

from .base import (CAP_EPILOGUE, CAP_GEMM, CAP_GRAD, CAP_INT8, CAP_INTERPRET,
                   CAP_ORACLE, CAP_SIM, CAP_TILED, CAP_VPU, CostModel, Engine,
                   Telemetry)
from .registry import (OpVariant, add_registry_listener, find_engine,
                       get_engine, list_engines, op_variants,
                       register_engine, register_op_impl, registered,
                       remove_registry_listener, resolve_op,
                       unregister_engine)
from .builtin import CudaTiledEngine, ReferenceEngine, TorchEngine
from .sim import SIM_ENGINE_SPECS, SimPEEngine, make_sim_engines
from .dispatch import (DEFAULT_DISPATCHER, JOB_CLASSES, Dispatcher,
                       JobClassPolicy, current_scope_engine, dispatch_gemm,
                       engine_scope)

__all__ = [
    "Engine", "CostModel", "Telemetry",
    "CAP_GEMM", "CAP_EPILOGUE", "CAP_GRAD", "CAP_TILED", "CAP_INTERPRET",
    "CAP_SIM", "CAP_ORACLE", "CAP_INT8", "CAP_VPU",
    "register_engine", "unregister_engine", "get_engine", "find_engine",
    "list_engines", "registered",
    "add_registry_listener", "remove_registry_listener",
    "OpVariant", "register_op_impl", "resolve_op", "op_variants",
    "TorchEngine", "CudaTiledEngine", "ReferenceEngine",
    "SimPEEngine", "SIM_ENGINE_SPECS", "make_sim_engines",
    "Dispatcher", "DEFAULT_DISPATCHER", "dispatch_gemm",
    "engine_scope", "current_scope_engine",
    "JobClassPolicy", "JOB_CLASSES", "ENGINE_NAME_MAP",
]

#: ``repro`` engine name -> its counterpart here, for comparing dispatch
#: decisions across the two packages (the simulated PEs keep their names)
ENGINE_NAME_MAP: dict[str, str] = {
    "xla": "torch", "pallas": "cuda-tiled", "reference": "reference",
    **{kind: kind for kind in SIM_ENGINE_SPECS},
}


def _register_defaults() -> None:
    for eng in (TorchEngine(), CudaTiledEngine(), ReferenceEngine(),
                *make_sim_engines()):
        if find_engine(eng.name) is None:
            register_engine(eng)


_register_defaults()
