"""Synergy core: tile-job decomposition, the im2col lowering, the
``synergy_matmul`` dispatch surface and inter-frame pipelining.

All dense compute dispatches through the engine registry in
:mod:`repro_torch.engines`."""

from .job import Job, JobSet, ceil_div
from .synergy_mm import SynergyTrace, synergy_matmul, current_trace
from .pipeline import (EngineStage, PipelineStageError, ThreadedPipeline,
                       gpipe_reference, gpipe_spmd)
from .im2col import im2col, im2col_wave, conv2d_gemm, conv_out_shape
from .serving import (DecodeJob, PrefillJob, Request, ServeStats,
                      ServeTimeoutError, SynergyServer, TenantStats)
