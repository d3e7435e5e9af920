"""The port's metrics exposition (``obs/metrics.py``, a copy of repro's)
against repro's on the CPU: counters, gauges and fixed-bucket histograms
render the same Prometheus text and parse back, conflicts raise the same
errors, ``observe`` allocates nothing, and the runtime, calibrator and
server collectors render the same families as repro's from the same
views."""

import types

import jax.numpy as jnp
import pytest
import torch

from repro.core.job import JobSet as JaxJobSet
from repro.obs import MetricsRegistry as JaxMetricsRegistry
from repro.obs import metrics as jax_metrics
from repro.obs import render_prometheus as jax_render_prometheus
from repro.soc import SynergyRuntime as JaxSynergyRuntime
from repro_torch.core.job import JobSet
from repro_torch.obs import (REGISTRY, MetricsRegistry, parse_prometheus,
                             render_prometheus)
from repro_torch.obs.metrics import (Histogram, collect_calibrator,
                                     collect_server)
from repro_torch.soc import SynergyRuntime

TIMEOUT = 30


def _fill(reg):
    reg.counter("obs_test_total", "a counter").inc(3)
    reg.gauge("obs_test_depth", "a gauge", ("engine",)).labels("e0").set(2.5)
    reg.gauge("obs_test_depth", "a gauge", ("engine",)).labels(
        engine='q"uo\\te').set(-1)
    h = reg.histogram("obs_test_wait_seconds", "a histogram",
                      buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg.render()


def test_metrics_render_and_parse_round_trip():
    text = _fill(MetricsRegistry())
    assert text == _fill(JaxMetricsRegistry())
    parsed = parse_prometheus(text)
    assert parsed == jax_metrics.parse_prometheus(text)
    assert parsed["obs_test_total"] == [({}, 3.0)]
    assert parsed["obs_test_depth"] == [({"engine": "e0"}, 2.5),
                                        ({"engine": 'q"uo\\te'}, -1.0)]
    buckets = {lb["le"]: v
               for lb, v in parsed["obs_test_wait_seconds_bucket"]}
    assert buckets == {"0.1": 1.0, "1": 2.0, "+Inf": 3.0}   # cumulative
    assert parsed["obs_test_wait_seconds_count"] == [({}, 3.0)]
    assert parsed["obs_test_wait_seconds_sum"][0][1] == pytest.approx(5.55)


def test_metrics_type_conflict_rejected_as_in_repro():
    for cls in (MetricsRegistry, JaxMetricsRegistry):
        reg = cls()
        reg.counter("obs_conflict")
        with pytest.raises(ValueError, match="re-registered"):
            reg.gauge("obs_conflict")
        with pytest.raises(ValueError, match="re-registered"):
            reg.counter("obs_conflict", labelnames=("engine",))
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("bad name!")
        with pytest.raises(ValueError, match="invalid label name"):
            reg.gauge("obs_ok", labelnames=("bad-label",))
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("obs_up").inc(-1)
    with pytest.raises(ValueError, match="malformed"):
        parse_prometheus("not a sample line at all")


def test_histogram_observe_is_allocation_free():
    h = Histogram(buckets=(1.0, 2.0))
    h.observe(0.5)
    import tracemalloc
    tracemalloc.start()
    for _ in range(100):
        h.observe(1.5)
    current, _ = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert current < 512        # bookkeeping noise only, no per-obs allocs
    assert h.count == 101
    assert h.snapshot() == ([1, 100, 0], 150.5, 101)


def _families(text):
    return {line.split()[2]: line.split()[3] for line in text.splitlines()
            if line.startswith("# TYPE")}


def test_render_prometheus_covers_runtime_views():
    """The port's runtime renders the same metric families, types and
    engine labels as repro's runtime over the same pool and GEMM, and the
    job counts equal its ``stats()``."""
    reg = MetricsRegistry()
    with SynergyRuntime(["F-PE", "S-PE"], name="obs-m", device="cpu") as rt:
        rt.submit_gemm(torch.ones(64, 32), torch.ones(32, 32),
                       jobset=JobSet.for_gemm(0, 64, 32, 32, 32),
                       tile=(32, 32, 32)).result(TIMEOUT)
        text = render_prometheus(runtime=rt, registry=reg)
        total_jobs = rt.stats()["total_jobs"]
    jreg = JaxMetricsRegistry()
    with JaxSynergyRuntime(["F-PE", "S-PE"], name="obs-m") as jrt:
        jrt.submit_gemm(jnp.ones((64, 32)), jnp.ones((32, 32)),
                        jobset=JaxJobSet.for_gemm(0, 64, 32, 32, 32),
                        tile=(32, 32, 32)).result(TIMEOUT)
        jtext = jax_render_prometheus(runtime=jrt, registry=jreg)
    assert _families(text) == _families(jtext)
    parsed, jparsed = parse_prometheus(text), parse_prometheus(jtext)
    for name in ("repro_engine_queue_depth", "repro_engine_jobs_total",
                 "repro_engine_steals_total", "repro_engine_busy_fraction",
                 "repro_runtime_steal_rate",
                 "repro_runtime_submissions_total"):
        assert name in parsed, name
    engines = {lb["engine"] for lb, _ in parsed["repro_engine_jobs_total"]}
    assert engines == {"F-PE", "S-PE"}
    total = sum(v for _, v in parsed["repro_engine_jobs_total"])
    assert total == total_jobs == sum(
        v for _, v in jparsed["repro_engine_jobs_total"])
    assert parsed["repro_runtime_submissions_total"] == \
        jparsed["repro_runtime_submissions_total"] == [({}, 1.0)]


def _server_view():
    tenant = types.SimpleNamespace(tokens_out=40, admitted=4, rejected=1,
                                   queue_wait_s=0.25, deadline_hits=3,
                                   deadline_misses=1,
                                   deadline_attainment=0.75)
    stats = types.SimpleNamespace(
        tokens_out=123, prefills=4, decode_steps=31, admission_rejects=1,
        shed_engagements=2, replayed_tokens=5, snapshots=1, restores=0,
        inflight_peak=3, tenants={"t0": tenant})
    return types.SimpleNamespace(stats=stats, _shed_level=1,
                                 _inflight=[1, 2], pending=[1, 2, 3],
                                 runtime=None)


def test_server_and_calibrator_collectors_render_as_repro():
    """``collect_server`` reads only attributes and ``collect_calibrator``
    an engine's calibrator state: the same views render the same text."""
    cal = types.SimpleNamespace(
        min_updates=2,
        state=lambda: {"a": types.SimpleNamespace(updates=3),
                       "b": types.SimpleNamespace(updates=1)})
    eng = types.SimpleNamespace(name="q-int8", calibrator=cal)
    texts = []
    for reg, server, calib in (
            (MetricsRegistry(), collect_server, collect_calibrator),
            (JaxMetricsRegistry(), jax_metrics.collect_server,
             jax_metrics.collect_calibrator)):
        server(_server_view(), reg)
        calib(eng, reg)
        texts.append(reg.render())
    assert texts[0] == texts[1]
    parsed = parse_prometheus(texts[0])
    assert parsed["repro_serve_tokens_total"] == [({}, 123.0)]
    assert parsed["repro_tenant_deadline_attainment"] == [
        ({"tenant": "t0"}, 0.75)]
    assert parsed["repro_calibrator_published_shapes"] == [
        ({"engine": "q-int8"}, 1.0)]


def test_the_process_registry_is_shared():
    assert isinstance(REGISTRY, MetricsRegistry)
    from repro_torch.obs import metrics
    assert metrics.REGISTRY is REGISTRY


def test_render_prometheus_of_a_mirrored_server_run_equals_repros():
    """``render_prometheus(runtime=rt, server=srv)`` after the same
    tenanted run on repro's server and the port's (one F-PE worker each):
    the same text, sample for sample, but for the samples that read the
    host's wall clock (busy fraction, queue-wait seconds)."""
    import numpy as np
    from repro.soc import Tenant as JaxTenant
    from repro_torch.soc import Tenant
    from test_torch_serving import (assert_same_stats, outs, requests,
                                    servers, submit_all)

    wall_clock = {"repro_engine_busy_fraction",
                  "repro_tenant_queue_wait_seconds_total"}
    jrt = JaxSynergyRuntime(["F-PE"], name="obs-serve")
    trt = SynergyRuntime(["F-PE"], name="obs-serve", device="cpu")
    with jrt, trt:
        js, ts = servers(slots=2, jax_kw={"runtime": jrt,
                                          "tenants": [JaxTenant("t0")]},
                         torch_kw={"runtime": trt,
                                   "tenants": [Tenant("t0")]})
        jr, tr = requests(3, max_new=3, tenant="t0",
                          toks=lambda i: np.arange(4) + i)
        submit_all(js, jr)
        submit_all(ts, tr)
        jst, tst = js.run(), ts.run()
        text = render_prometheus(runtime=trt, server=ts,
                                 registry=MetricsRegistry())
        jtext = jax_render_prometheus(runtime=jrt, server=js,
                                      registry=JaxMetricsRegistry())
    assert outs(tr) == outs(jr)
    assert_same_stats(jst, tst)
    assert _families(text) == _families(jtext)
    parsed, jparsed = parse_prometheus(text), parse_prometheus(jtext)
    assert parsed.keys() == jparsed.keys()
    for name in parsed:
        if name in wall_clock:
            assert [lb for lb, _ in parsed[name]] == \
                [lb for lb, _ in jparsed[name]], name
        else:
            assert parsed[name] == jparsed[name], name
    assert parsed["repro_serve_tokens_total"] == [({}, tst.tokens_out)]
    assert parsed["repro_tenant_admitted_total"] == [({"tenant": "t0"},
                                                      3.0)]
    assert {lb["engine"] for lb, _ in parsed["repro_engine_jobs_total"]} \
        == {"F-PE"}
