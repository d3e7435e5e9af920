"""The port's elastic-training fault tolerance
(``repro_torch.runtime.fault_tolerance``: the heartbeat monitor, elastic
re-meshing and the checkpoint/restart supervisor) against ``repro``'s
functions on the same inputs, scenario for scenario of
``tests/test_fault_tolerance.py``.  The straggler rebalancer's tests are
in ``tests/test_torch_runtime.py``."""

import dataclasses

import pytest

import repro.runtime.fault_tolerance as jax_ft
import repro_torch.runtime.fault_tolerance as ft
from repro.soc import RetryPolicy as JaxRetryPolicy
from repro_torch.soc import RetryPolicy

SIDES = [ft, jax_ft]


# ------------------------------------------------------------ heartbeat

def _silent_host(mod):
    hb = mod.HeartbeatMonitor(n_hosts=4, timeout_steps=3)
    verdicts = []
    for step in range(1, 6):
        for h in (0, 1, 3):               # host 2 goes silent after step 0
            hb.beat(h, step)
        verdicts.append(hb.failed_hosts(step))
    late = hb.failed_hosts(step=5)
    hb.beat(2, 5)                         # a late beat clears the verdict
    return verdicts, late, hb.failed_hosts(step=5), list(hb.last_seen)


def test_heartbeat_monitor_flags_silent_hosts():
    got, want = _silent_host(ft), _silent_host(jax_ft)
    assert got == want
    verdicts, late, cleared, _ = got
    assert late == [2] and cleared == []
    assert verdicts == [[], [], [], [2], [2]]


def test_heartbeat_monitor_timeout_boundary():
    for mod in SIDES:
        hb = mod.HeartbeatMonitor(n_hosts=1, timeout_steps=3)
        hb.beat(0, 10)
        assert hb.failed_hosts(13) == []  # exactly timeout_steps late: alive
        assert hb.failed_hosts(14) == [0]  # one step beyond: failed
    # every (last beat, step, timeout) alike in both
    for timeout in (0, 1, 3, 7):
        a = ft.HeartbeatMonitor(n_hosts=3, timeout_steps=timeout)
        b = jax_ft.HeartbeatMonitor(n_hosts=3, timeout_steps=timeout)
        for hb in (a, b):
            hb.beat(1, 4)
            hb.beat(2, 9)
        for step in range(0, 20):
            assert a.failed_hosts(step) == b.failed_hosts(step)


def test_soc_runtime_reuses_heartbeat_monitor_definition():
    """The runtime's worker-death detector is the same class, and
    RetryPolicy.timeout_steps converts its wall-clock knobs into the
    monitor's step timeout exactly as repro's does."""
    import repro_torch.soc.runtime as soc_runtime
    assert soc_runtime.HeartbeatMonitor is ft.HeartbeatMonitor
    retry = RetryPolicy(heartbeat_timeout_s=0.5, monitor_interval_s=0.1)
    assert retry.timeout_steps == JaxRetryPolicy(
        heartbeat_timeout_s=0.5, monitor_interval_s=0.1).timeout_steps == 5
    hb = ft.HeartbeatMonitor(n_hosts=2, timeout_steps=retry.timeout_steps)
    hb.beat(0, 5)
    assert hb.failed_hosts(7) == [1]      # never beat past construction


# ------------------------------------------------------- elastic re-mesh

@pytest.mark.parametrize("n,mp,pods", [(64, 16, 1), (63, 16, 1), (16, 16, 1),
                                       (64, 16, 2), (32, 16, 2),
                                       (256, 16, 2), (17, 4, 3), (8, 1, 1)])
def test_plan_elastic_mesh_matches_repro(n, mp, pods):
    assert (ft.plan_elastic_mesh(n, model_parallel=mp, pods=pods)
            == jax_ft.plan_elastic_mesh(n, model_parallel=mp, pods=pods))


def test_plan_elastic_mesh_drops_data_replicas():
    assert ft.plan_elastic_mesh(64, model_parallel=16) == (4, 16)
    assert ft.plan_elastic_mesh(63, model_parallel=16) == (3, 16)


def test_plan_elastic_mesh_pods_axis():
    assert ft.plan_elastic_mesh(64, model_parallel=16, pods=2) == (2, 2, 16)
    assert ft.plan_elastic_mesh(32, model_parallel=16, pods=2) == (2, 1, 16)


def test_plan_elastic_mesh_too_few_survivors():
    for mod in SIDES:
        with pytest.raises(RuntimeError, match="cannot re-mesh"):
            mod.plan_elastic_mesh(15, model_parallel=16)


# ------------------------------------------------- checkpoint supervisor

class _Ckpt:
    """Duck-typed checkpointer: remembers the last saved (step, state)."""

    def __init__(self):
        self.step = None
        self.state = None
        self.restores = 0

    def save(self, step, state):
        self.step, self.state = step, state

    def latest_step(self):
        return self.step

    def restore(self, _state):
        self.restores += 1
        return self.state


def _events(failures):
    return [dataclasses.astuple(f) for f in failures]


def _restore_and_resume(mod):
    ckpt = _Ckpt()
    crashed, starts = [], []

    def run_steps(start, end, state):
        starts.append(start)
        for step in range(start, end):
            if step == 5 and not crashed:
                crashed.append(step)
                raise RuntimeError("host 3 lost")
            state += 1
            ckpt.save(step + 1, state)
        return state

    events = []
    final, failures = mod.run_with_recovery(
        steps=10, run_steps=run_steps, checkpointer=ckpt, state0=0,
        on_failure=events.append)
    assert events == failures and isinstance(events[0], mod.FailureEvent)
    return final, ckpt.restores, starts, _events(failures)


def test_run_with_recovery_restores_and_resumes():
    got = _restore_and_resume(ft)
    assert got == _restore_and_resume(jax_ft)
    final, restores, starts, failures = got
    # resumed from the step-5 checkpoint: exactly 10 increments in all
    assert final == 10 and restores == 1 and starts == [0, 5]
    assert [f[1] for f in failures] == ["step-exception"]
    assert failures[0] == (0, "step-exception", "RuntimeError: host 3 lost")


def _cold_restart(mod):
    calls = []

    def run_steps(start, end, state):
        calls.append(start)
        if len(calls) == 1:
            raise RuntimeError("early fault")
        return state + (end - start)

    ckpt = _Ckpt()
    final, failures = mod.run_with_recovery(
        steps=4, run_steps=run_steps, checkpointer=ckpt, state0=0)
    return final, calls, ckpt.restores, _events(failures)


def test_run_with_recovery_cold_restart_without_checkpoint():
    got = _cold_restart(ft)
    assert got == _cold_restart(jax_ft)
    final, calls, restores, failures = got
    assert final == 4 and calls == [0, 0]   # no checkpoint: restart at 0
    assert restores == 0 and len(failures) == 1


def _too_many(mod, max_restarts):
    calls, events = [], []

    def run_steps(start, end, state):
        calls.append(start)
        raise RuntimeError("always down")

    with pytest.raises(RuntimeError,
                       match=f"exceeded {max_restarts} restarts") as ei:
        mod.run_with_recovery(steps=3, run_steps=run_steps,
                              checkpointer=_Ckpt(), state0=0,
                              max_restarts=max_restarts,
                              on_failure=events.append)
    return (len(calls), _events(events), type(ei.value.__cause__).__name__,
            str(ei.value.__cause__))


@pytest.mark.parametrize("max_restarts", [0, 2, 3])
def test_run_with_recovery_exceeds_max_restarts(max_restarts):
    got = _too_many(ft, max_restarts)
    assert got == _too_many(jax_ft, max_restarts)
    n_calls, events, cause, msg = got
    assert n_calls == len(events) == max_restarts + 1
    assert (cause, msg) == ("RuntimeError", "always down")

