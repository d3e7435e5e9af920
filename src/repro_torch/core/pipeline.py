"""Inter-frame pipelining (paper C4).

:class:`ThreadedPipeline` is the paper's HW/SW multi-threaded pipeline:
one thread per layer/stage, a mailbox (bounded synchronized FIFO) between
stages, several frames in flight.  Its stages are plain callables or
:class:`EngineStage` objects pinned to a registered engine, so each stage's
GEMMs run on the kernel its engine names (``cuda-tiled`` on K1,
``neon-vpu`` on K3) while the other stages' threads launch theirs.
:func:`gpipe_reference` is the microbatch oracle: every stage applied to
each microbatch in turn.  :func:`gpipe_spmd` is the pod-scale pipeline: a
GPipe microbatch schedule across one axis of a ``DeviceMesh``, one stage
per rank, activations passed on by point-to-point sends (``repro``'s
``shard_map`` + ``ppermute``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

__all__ = ["ThreadedPipeline", "EngineStage", "StageStats",
           "PipelineStageError", "gpipe_reference", "gpipe_spmd"]


# ---------------------------------------------------------------------------
# Threaded layer pipeline with mailboxes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageStats:
    name: str
    busy_s: float = 0.0
    frames: int = 0
    engine: Optional[str] = None


@dataclasses.dataclass
class EngineStage:
    """A pipeline stage bound to the engine registry.

    ``fn`` processes one frame's payload; ``engine`` (optional) pins the
    stage's GEMMs to a registered engine — the worker runs ``fn`` under
    ``repro_torch.engines.engine_scope``, so every ``synergy_matmul``
    inside routes there, and the stage is attributed in the run stats.
    :meth:`gemm` builds the common case — a stage that IS one dense GEMM —
    directly on ``synergy_matmul``, so stage compute flows through the
    same dispatch surface as everything else."""

    name: str
    fn: Callable[[Any], Any]
    engine: Optional[str] = None

    @classmethod
    def gemm(cls, name: str, w, *, bias=None, activation=None,
             tile=None, engine: Optional[str] = None) -> "EngineStage":
        from .synergy_mm import DEFAULT_TILE, synergy_matmul
        tile = tile if tile is not None else DEFAULT_TILE

        def fn(a):
            return synergy_matmul(a, w, bias=bias, activation=activation,
                                  tile=tile, name=name, engine=engine)
        return cls(name, fn, engine)

    def __call__(self, payload):
        return self.fn(payload)


def _as_stage(spec: Union["EngineStage", tuple]) -> EngineStage:
    if isinstance(spec, EngineStage):
        return spec
    name, fn = spec
    return EngineStage(name, fn)


_STOP = object()


@dataclasses.dataclass
class _Failure:
    """A stage exception, traveling the pipe in place of the frame so every
    downstream mailbox keeps draining (no deadlock)."""

    stage: str
    error: BaseException


class PipelineStageError(RuntimeError):
    """Raised by :meth:`ThreadedPipeline.run` when a stage raised; the
    original exception is chained as ``__cause__``."""


class ThreadedPipeline:
    """Producer/consumer layer pipeline (paper §3.1, Figure 2).

    stages: list of :class:`EngineStage` or (name, fn) tuples — fn
    processes one frame's payload.  mailbox_capacity bounds frames in
    flight between adjacent stages.

    ``runtime``: an optional :class:`repro_torch.soc.SynergyRuntime` —
    stage workers run under its :func:`~repro_torch.soc.runtime_scope`,
    so stage GEMMs split across the engine pool and an
    ``EngineStage.engine`` pin becomes a queue-affinity hint rather than a
    hard route.  When None, a runtime scope active in the caller's thread
    at :meth:`run` time is inherited.  Scopes are per thread, so each
    stage worker enters its engine pin and the runtime scope itself.

    A raising stage does NOT deadlock the pipe: the exception travels
    downstream as a poison frame, every worker keeps draining its inbox,
    and :meth:`run` re-raises :class:`PipelineStageError` after joining.
    """

    def __init__(self,
                 stages: Sequence[Union[EngineStage,
                                        tuple[str, Callable[[Any], Any]]]],
                 mailbox_capacity: int = 4,
                 runtime: Optional[Any] = None):
        self.stages = [_as_stage(s) for s in stages]
        self.mailboxes = [queue.Queue(maxsize=mailbox_capacity)
                          for _ in range(len(self.stages) + 1)]
        self.stats = [StageStats(s.name, engine=s.engine)
                      for s in self.stages]
        self.runtime = runtime

    def _worker(self, idx: int, runtime) -> None:
        import contextlib

        from repro_torch.engines import engine_scope
        stage = self.stages[idx]
        fn = stage.fn
        if stage.engine is not None:
            raw = fn

            def fn(item):
                with engine_scope(stage.engine):
                    return raw(item)
        inbox, outbox = self.mailboxes[idx], self.mailboxes[idx + 1]
        st = self.stats[idx]
        if runtime is not None:
            from repro_torch.soc import runtime_scope
            scope = runtime_scope(runtime)
        else:
            scope = contextlib.nullcontext()
        with scope:
            while True:
                item = inbox.get()
                if item is _STOP:
                    outbox.put(_STOP)
                    return
                if isinstance(item, _Failure):   # pass the poison through
                    outbox.put(item)
                    continue
                t0 = time.perf_counter()
                try:
                    out = fn(item)
                except BaseException as e:
                    out = _Failure(stage.name, e)
                st.busy_s += time.perf_counter() - t0
                st.frames += 1
                outbox.put(out)

    def run(self, frames: Sequence[Any]) -> tuple[list[Any], dict]:
        runtime = self.runtime
        if runtime is None:
            from repro_torch.soc import current_runtime
            runtime = current_runtime()
        threads = [threading.Thread(target=self._worker, args=(i, runtime),
                                    daemon=True)
                   for i in range(len(self.stages))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        feeder = threading.Thread(
            target=lambda: ([self.mailboxes[0].put(f) for f in frames],
                            self.mailboxes[0].put(_STOP)),
            daemon=True)
        feeder.start()
        outputs = []
        failure: Optional[_Failure] = None
        while True:
            item = self.mailboxes[-1].get()
            if item is _STOP:
                break
            if isinstance(item, _Failure):
                failure = failure or item       # keep draining to _STOP
                continue
            outputs.append(item)
        wall = time.perf_counter() - t0
        for t in threads:
            t.join()
        feeder.join()
        if failure is not None:
            raise PipelineStageError(
                f"stage {failure.stage!r} raised "
                f"{type(failure.error).__name__}: {failure.error}"
            ) from failure.error
        util = {s.name: (s.busy_s / wall if wall > 0 else 0.0) for s in self.stats}
        return outputs, {
            "wall_s": wall,
            "fps": len(outputs) / wall if wall > 0 else 0.0,
            "stage_utilization": util,
            "stage_engines": {s.name: s.engine for s in self.stats
                              if s.engine is not None},
            "runtime": runtime.stats() if runtime is not None else None,
        }


# ---------------------------------------------------------------------------
# GPipe microbatch pipeline over a mesh axis, and its oracle
# ---------------------------------------------------------------------------

def gpipe_reference(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    stage_params: Sequence[Any],
                    microbatches: torch.Tensor) -> torch.Tensor:
    """Oracle: apply stages sequentially to each microbatch.

    stage_params: length-S list of per-stage params; microbatches: (M, ...).
    """
    def per_mb(x):
        for p in stage_params:
            x = stage_fn(p, x)
        return x
    return torch.stack([per_mb(x) for x in microbatches])


def gpipe_spmd(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
               my_params: Any,
               microbatches: torch.Tensor,
               *,
               mesh,
               axis_name: str,
               num_stages: int) -> torch.Tensor:
    """GPipe forward pipeline, called on EVERY rank of ``mesh``.

    Each rank along ``axis_name`` holds one stage's params (``my_params``)
    and the full microbatch stream (M, ...) enters at stage 0.  The schedule
    runs M + S - 1 ticks; at each tick every stage processes its current
    microbatch and sends the activation to the next stage
    (``batch_isend_irecv`` over the axis's group; the last stage sends
    nothing, as ``repro``'s ring permute's last->first edge is unused).

    Returns the (M, ...) outputs, valid on the LAST stage (stage < S-1
    ranks return zeros) — callers typically gather the result back.
    """
    group = mesh.get_group(axis_name)
    stage = mesh.get_local_rank(axis_name)
    assert dist.get_world_size(group) == num_stages
    m = microbatches.shape[0]
    ticks = m + num_stages - 1
    x_shape = microbatches.shape[1:]
    nxt = (dist.get_global_rank(group, stage + 1)
           if stage < num_stages - 1 else None)
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None

    # stages must preserve activation shape (residual-block property), so the
    # output stream has the input microbatch shape.
    outputs = torch.zeros((m,) + x_shape, dtype=microbatches.dtype,
                          device=microbatches.device)
    state = torch.zeros(x_shape, dtype=microbatches.dtype,
                        device=microbatches.device)
    for t in range(ticks):
        # stage 0 injects microbatch t (the last one again past the end)
        x_in = microbatches[min(t, m - 1)] if stage == 0 else state
        y = stage_fn(my_params, x_in)
        # collect the finished microbatch on the last stage
        out_idx = t - (num_stages - 1)
        if stage == num_stages - 1 and 0 <= out_idx < m:
            outputs[out_idx] = y
        # shift activations stage i -> i+1
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prv is not None:
            state = torch.empty_like(state)
            ops.append(dist.P2POp(dist.irecv, state, prv, group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    return outputs
