"""Fault tolerance for 1000+-node runs: failure detection, checkpoint/
restart, and elastic re-meshing.

Architecture (mirrors what production TPU frameworks do, testable on CPU):

  * ``HeartbeatMonitor`` — every worker (host) posts a heartbeat each step;
    the coordinator flags hosts silent for > ``timeout_steps`` as failed.
  * ``run_with_recovery`` — the supervisor loop: run the train loop; on
    worker failure (or any step exception), restore the latest atomic
    checkpoint, optionally RE-MESH to the surviving device set (elastic:
    drop a data-parallel replica, keep model-parallel intact), and resume
    from the same data step (the pipeline is deterministic in (seed, step),
    so no data is skipped or repeated).
  * Straggler mitigation lives in ``straggler.py`` (the Synergy
    work-stealing insight applied between steps).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

__all__ = ["HeartbeatMonitor", "FailureEvent", "run_with_recovery",
           "plan_elastic_mesh"]


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str                  # 'host-timeout' | 'step-exception'
    detail: str


class HeartbeatMonitor:
    """Step-granularity heartbeat tracking (wall-clock optional)."""

    def __init__(self, n_hosts: int, timeout_steps: int = 3):
        self.n_hosts = n_hosts
        self.timeout_steps = timeout_steps
        self.last_seen = [0] * n_hosts

    def beat(self, host: int, step: int) -> None:
        self.last_seen[host] = step

    def failed_hosts(self, step: int) -> list[int]:
        return [h for h, s in enumerate(self.last_seen)
                if step - s > self.timeout_steps]


def plan_elastic_mesh(n_devices: int, model_parallel: int,
                      pods: int = 1) -> tuple[int, ...]:
    """Largest (data, model) mesh fitting the surviving devices: model
    parallelism is load-bearing (weights are sharded 16-way), so the DATA
    axis absorbs the loss — drop whole DP replicas of `model_parallel`
    devices.  Returns the new mesh shape."""
    if n_devices < model_parallel:
        raise RuntimeError(
            f"cannot re-mesh: {n_devices} survivors < model={model_parallel}")
    data = n_devices // model_parallel
    if pods > 1:
        return (pods, max(1, data // pods), model_parallel)
    return (data, model_parallel)


def run_with_recovery(*,
                      steps: int,
                      run_steps: Callable[[int, int, Any], Any],
                      checkpointer,
                      state0: Any,
                      max_restarts: int = 3,
                      on_failure: Callable[[FailureEvent], None] | None = None,
                      ) -> tuple[Any, list[FailureEvent]]:
    """Supervisor: ``run_steps(start, end, state) -> state`` may raise at
    any step; we restore the latest checkpoint and resume.  Returns
    (final state, failure log)."""
    failures: list[FailureEvent] = []
    restarts = 0
    state = state0
    start = 0
    while start < steps:
        try:
            state = run_steps(start, steps, state)
            break
        except Exception as e:  # noqa: BLE001 — any worker fault
            restarts += 1
            ev = FailureEvent(step=start, kind="step-exception",
                              detail=f"{type(e).__name__}: {e}")
            failures.append(ev)
            if on_failure:
                on_failure(ev)
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} restarts") from e
            ckpt_step = checkpointer.latest_step()
            if ckpt_step is None:
                state = state0
                start = 0
            else:
                state = checkpointer.restore(state)
                start = ckpt_step
    return state, failures
