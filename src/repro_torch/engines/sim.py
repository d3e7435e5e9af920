"""Simulated Zynq accelerators as registry engines (paper §3.1.1 / §4).

The calibrated rate constants of the paper's Zynq PEs are the cost models
of ordinary registered engines, so the discrete-event simulator, the LPT planner, the rebalancer
and the dispatcher all read ONE source of truth.  A SimPEEngine is fully
executable (it runs the plain fp32 oracle), so a "paper PE" can also serve
real GEMMs in tests and demos.

Calibration (documented; reproduces the paper's Figures 9/13/14, Table 6):

  * F-PE: HLS loop pipelining at loop2, II limited by BRAM ports to TS/2=16
    cycles per merged iteration; ~2 MAC/cycle @ 100 MHz minus BRAM-port
    stalls and job-fetch gaps -> 0.125 GMAC/s sustained.
  * S-PE: unroll(2) + pipelining at loop3 -> 0.5x F-PE.
  * NEON: calibrated from the paper's measurement that adding 2 NEONs to
    the 6F+2S FPGA config improves latency by ~12% (Fig 11):
    2*x = 0.12*7.0 F-PE-units -> x = 0.42 F-PE-units.
  * ARM A9 (Darknet -O3): Table 3, ~0.14 GMAC/s on conv gemm single
    thread; other layers ~0.5 Gop/s; im2col ~0.8 GB/s effective copy BW.
  * Per-job dispatch: 30 us ReconOS delegate-thread round trip.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.kernels.tiled_mm.ref import tiled_mm_ref

from .base import CAP_EPILOGUE, CAP_GEMM, CAP_SIM, CostModel, Engine

__all__ = ["SimPEEngine", "SIM_ENGINE_SPECS"]

_RECONOS_DISPATCH_S = 30e-6
_F_PE_MACS_PER_S = 0.125e9

#: kind -> calibrated cost model (rates in absolute MAC/s)
SIM_ENGINE_SPECS: dict[str, CostModel] = {
    "F-PE": CostModel(_F_PE_MACS_PER_S, dispatch_s=_RECONOS_DISPATCH_S),
    "S-PE": CostModel(0.5 * _F_PE_MACS_PER_S, dispatch_s=_RECONOS_DISPATCH_S),
    "NEON": CostModel(0.42 * _F_PE_MACS_PER_S, dispatch_s=_RECONOS_DISPATCH_S),
    # the host ARM A9 pair: conv MACs + elementwise ops + im2col copies
    "ARM": CostModel(0.14e9, dispatch_s=0.0, bytes_per_s=0.8e9,
                     ops_per_s=0.5e9),
}


class SimPEEngine(Engine):
    """A calibrated paper PE: cost model drives the DES + planners; execute
    runs the plain fp32 oracle so the engine is also runnable."""

    def __init__(self, name: str, cost: CostModel,
                 capabilities: frozenset[str] | set[str] = frozenset()):
        super().__init__(name, {CAP_GEMM, CAP_EPILOGUE, CAP_SIM}
                         | set(capabilities), cost=cost)

    def recalibrate(self, observed_macs_per_s: float,
                    alpha: float = 0.5) -> float:
        """No-op: this cost model is the PAPER's calibrated constant for
        hardware that is not actually here — a measured host-oracle rate
        would corrupt every DES/LPT/Table-6 result that reads it."""
        return self.cost.macs_per_s

    def execute(self, a, b, *, bias=None, activation: Callable | None = None,
                tile=(256, 256, 256), out_dtype=None):
        return tiled_mm_ref(a, b, bias=bias, activation=activation,
                            out_dtype=out_dtype)


def make_sim_engines() -> list[SimPEEngine]:
    return [SimPEEngine(kind, cost) for kind, cost in SIM_ENGINE_SPECS.items()]
