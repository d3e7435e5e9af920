"""Synergy core: tile-job decomposition, the im2col lowering and the
``synergy_matmul`` dispatch surface.

All dense compute dispatches through the engine registry in
:mod:`repro_torch.engines`."""

from .job import Job, JobSet, ceil_div
from .synergy_mm import SynergyTrace, synergy_matmul, current_trace
from .im2col import im2col, im2col_wave, conv2d_gemm, conv_out_shape
