"""The port's serving tenancy (``SynergyServer(tenants=...)``) against
``repro``'s on the CPU: the server scenarios of ``tests/test_qos.py`` —
bounded queues and ``AdmissionRejected`` with a cost-model retry-after,
weighted fair admission, the shed ladder's int8 degradation, per-tenant
stats, deadline accounting and token parity of a tenanted server with the
untenanted FIFO server — run on both servers over the same reduced config
and weights, with the same decisions, tokens and counters.  The helpers
are ``tests/test_torch_serving.py``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import serving as jax_serving
from repro.engines import get_engine as jax_get_engine
from repro.quant import QuantizedEngine as JaxQuantizedEngine
from repro.soc import AdmissionRejected as JaxAdmissionRejected
from repro.soc import QosClass as JaxQosClass
from repro.soc import SynergyRuntime as JaxRuntime
from repro.soc import Tenant as JaxTenant
from repro.soc.qos import BULK as JAX_BULK
from repro.soc.qos import DEFAULT_CLASS as JAX_DEFAULT_CLASS
from repro_torch.core.serving import (Request, ServeTimeoutError,
                                      TenantStats)
from repro_torch.engines import get_engine
from repro_torch.quant import QuantizedEngine
from repro_torch.soc import (AdmissionRejected, QosClass, SynergyRuntime,
                             Tenant)
from repro_torch.soc.qos import BULK, DEFAULT_CLASS
from test_torch_serving import (FP32_TOL, assert_same_stats, outs,
                                requests, servers, submit_all)

GOLD = QosClass("gold", priority=10, deadline_s=120.0, weight=4.0)
JAX_GOLD = JaxQosClass("gold", priority=10, deadline_s=120.0, weight=4.0)


def tenants(*specs):
    """``(name, port class, repro class, max_pending)`` specs as the
    two servers' keyword arguments."""
    return ({"tenants": [JaxTenant(n, jq, max_pending=mp)
                         for n, _, jq, mp in specs]},
            {"tenants": [Tenant(n, q, max_pending=mp)
                         for n, q, _, mp in specs]})


def tenanted(slots=2, specs=(), **kw):
    jkw, tkw = tenants(*specs)
    return servers(slots=slots, jax_kw={**jkw, **kw.pop("jax_kw", {})},
                   torch_kw={**tkw, **kw.pop("torch_kw", {})}, **kw)


def both_requests(groups):
    """``[(n, tenant, base, max_new), ...]`` -> (repro's, port's)."""
    jr, tr = [], []
    for n, tenant, base, max_new in groups:
        j, t = requests(n, tenant=tenant, base=base, max_new=max_new)
        jr += j
        tr += t
    return jr, tr


def test_tenanted_server_end_to_end_stats():
    js, ts = tenanted(specs=[("gold", GOLD, JAX_GOLD, None),
                             ("bulk", BULK, JAX_BULK, None)])
    jr, tr = both_requests([(2, "gold", 0, 3), (3, "bulk", 10, 3)])
    submit_all(js, jr)
    submit_all(ts, tr)
    jst, stats = js.run(), ts.run()
    assert outs(tr) == outs(jr)
    assert_same_stats(jst, stats)
    assert all(len(r.out) >= 3 for r in tr)
    assert all(r.done_at is not None for r in tr)
    g, b = stats.tenants["gold"], stats.tenants["bulk"]
    assert g.admitted == 2 and b.admitted == 3
    assert g.prefills == 2 and b.prefills == 3
    assert g.tokens_out + b.tokens_out == stats.tokens_out
    assert g.queue_wait_s >= 0 and g.max_queue_wait_s >= 0
    assert g.deadline_hits + g.deadline_misses == 2
    assert g.deadline_attainment == 1.0
    assert b.deadline_hits == b.deadline_misses == 0
    assert b.deadline_attainment == 1.0


def test_unknown_tenant_and_constructor_validation():
    js, ts = tenanted(specs=[("a", DEFAULT_CLASS, JAX_DEFAULT_CLASS, None)])
    for srv, req in ((js, jax_serving.Request(0, jnp.arange(4), 2,
                                              tenant="nope")),
                     (ts, Request(0, torch.arange(4, dtype=torch.int32), 2,
                                  tenant="nope"))):
        with pytest.raises(KeyError, match="unknown tenant"):
            srv.submit(req)
    dup = [("a", DEFAULT_CLASS, JAX_DEFAULT_CLASS, None)] * 2
    with pytest.raises(ValueError, match="duplicate tenant"):
        servers(torch_kw=tenants(*dup)[1])
    with pytest.raises(ValueError, match="duplicate tenant"):
        servers(jax_kw=tenants(*dup)[0])
    with pytest.raises(ValueError, match="tenants"):
        servers(torch_kw={"tenants": []})
    with pytest.raises(ValueError, match="tenants"):
        servers(jax_kw={"tenants": []})


def test_bounded_queue_rejects_with_retry_after():
    js, ts = tenanted(specs=[("t", DEFAULT_CLASS, JAX_DEFAULT_CLASS, 2)])
    jr, tr = both_requests([(2, "t", 0, 2)])
    submit_all(js, jr)
    submit_all(ts, tr)
    with pytest.raises(JaxAdmissionRejected) as jei:
        js.submit(jax_serving.Request(9, jnp.arange(4), 2, tenant="t"))
    with pytest.raises(AdmissionRejected) as ei:
        ts.submit(Request(9, torch.arange(4, dtype=torch.int32), 2,
                          tenant="t"))
    assert ei.value.tenant == "t"
    assert ei.value.retry_after_s > 0
    assert ei.value.retry_after_s == pytest.approx(jei.value.retry_after_s,
                                                   rel=1e-12)
    assert "retry after" in str(ei.value)
    assert ts.stats.admission_rejects == js.stats.admission_rejects == 1
    assert ts.stats.tenants["t"].rejected == 1
    assert_same_stats(js.stats, ts.stats)


def test_untenanted_global_max_pending_bound():
    js, ts = servers(slots=2, max_pending=1)
    for srv, req_cls, arr, rejected in (
            (js, jax_serving.Request, jnp.asarray, JaxAdmissionRejected),
            (ts, Request, torch.from_numpy, AdmissionRejected)):
        srv.submit(req_cls(0, arr(np.arange(4, dtype=np.int32)), 2))
        with pytest.raises(rejected):
            srv.submit(req_cls(1, arr(np.arange(4, dtype=np.int32)), 2))
        assert srv.stats.admission_rejects == 1
        srv.pending.clear()           # the real mutable list is exposed
        srv.submit(req_cls(2, arr(np.arange(4, dtype=np.int32)), 2))
        assert len(srv.pending) == 1


def test_pending_property_tenanted_snapshot():
    js, ts = tenanted(specs=[("a", DEFAULT_CLASS, JAX_DEFAULT_CLASS, None),
                             ("b", DEFAULT_CLASS, JAX_DEFAULT_CLASS, None)])
    jr, tr = both_requests([(2, "a", 0, 3), (1, "b", 10, 3)])
    submit_all(js, jr)
    submit_all(ts, tr)
    assert len(ts.pending) == len(js.pending) == 3
    assert [r.rid for r in ts.pending] == [r.rid for r in js.pending]
    assert {r.tenant for r in ts.pending} == {"a", "b"}


def test_weighted_fair_admission_order():
    js, ts = tenanted(specs=[("gold", GOLD, JAX_GOLD, None),
                             ("bulk", BULK, JAX_BULK, None)])
    jr, tr = both_requests([(8, "gold", 0, 3), (8, "bulk", 100, 3)])
    submit_all(js, jr)
    submit_all(ts, tr)
    picked = ts._pick_requests(10)
    jpicked = js._pick_requests(10)
    assert len(ts.pending) == 16           # peek only: nothing popped
    names = [n for n, _ in picked]
    assert names[:8] == ["gold"] * 8
    assert names[8:] == ["bulk"] * 2
    assert [(n, r.rid) for n, r in picked] == \
        [(n, r.rid) for n, r in jpicked]
    assert ts._fair.snapshot() == js._fair.snapshot()


def test_shed_ladder_engages_and_degrades_decode():
    """Under queue pressure the ladder degrades SHEDDABLE tenants' decode
    to the int8-only job class BEFORE anything is rejected."""
    jpool = [jax_get_engine("F-PE"),
             JaxQuantizedEngine(jax_get_engine("xla"), name="int8-shed")]
    pool = [get_engine("F-PE"),
            QuantizedEngine(get_engine("torch"), name="int8-shed")]
    jrt = JaxRuntime(jpool, name="shed")
    trt = SynergyRuntime(pool, name="shed", device="cpu")
    with jrt, trt:
        js, ts = tenanted(specs=[("bulk", BULK, JAX_BULK, 4)],
                          jax_kw={"runtime": jrt},
                          torch_kw={"runtime": trt})
        jr, tr = both_requests([(4, "bulk", 0, 3)])
        submit_all(js, jr)
        submit_all(ts, tr)
        with pytest.raises(JaxAdmissionRejected):
            js.submit(jax_serving.Request(99, jnp.arange(4), 3,
                                          tenant="bulk"))
        with pytest.raises(AdmissionRejected):
            ts.submit(Request(99, torch.arange(4, dtype=torch.int32), 3,
                              tenant="bulk"))
        assert ts.stats.shed_engagements == 1  # 80% watermark crossed
        jst, stats = js.run(), ts.run()
    assert outs(tr) == outs(jr)
    assert_same_stats(jst, stats)
    assert stats.shed_degraded_steps > 0
    assert stats.tenants["bulk"].degraded_steps > 0


def test_serve_timeout_error_carries_identity():
    for cls in (ServeTimeoutError, jax_serving.ServeTimeoutError):
        err = cls("decode/s3", 1.5, {"F-PE": {"jobs": 2}}, rids=(7, 8),
                  tenants=("gold", "", "bulk"))
        assert err.rids == (7, 8)
        assert err.tenants == ("gold", "bulk")
        msg = str(err)
        assert "rids=[7, 8]" in msg and "'bulk'" in msg and "'gold'" in msg
        assert "rids" not in str(cls("x", 1.0, {}))
    assert str(ServeTimeoutError("decode/s3", 1.5, {"F-PE": {"jobs": 2}},
                                 rids=(7,), tenants=("gold",))) == \
        str(jax_serving.ServeTimeoutError("decode/s3", 1.5,
                                          {"F-PE": {"jobs": 2}}, rids=(7,),
                                          tenants=("gold",)))


def test_tenanted_matches_untenanted_tokens_bitwise():
    """QoS is a SCHEDULING layer only: on an unloaded pool a default-class
    tenanted server gives bitwise the untenanted FIFO server's tokens and
    decode-GEMM outputs, each within 1e-5 of repro's."""
    def run(tenanted_run):
        jrt = JaxRuntime(["F-PE", "S-PE"], name="parity")
        trt = SynergyRuntime(["F-PE", "S-PE"], name="parity", device="cpu")
        with jrt, trt:
            specs = ([("default", DEFAULT_CLASS, JAX_DEFAULT_CLASS, None)]
                     if tenanted_run else [])
            jkw, tkw = tenants(*specs) if specs else ({}, {})
            js, ts = servers(slots=2, keep_decode_outputs=True,
                             jax_kw={**jkw, "runtime": jrt},
                             torch_kw={**tkw, "runtime": trt})
            tname = "default" if tenanted_run else None
            jr, tr = requests(4, max_new=4, tenant=tname)
            submit_all(js, jr)
            submit_all(ts, tr)
            jst, tst = js.run(), ts.run()
        assert outs(tr) == outs(jr)
        assert_same_stats(jst, tst)
        for ja, ta in zip(js.decode_gemm_outputs, ts.decode_gemm_outputs):
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                       rtol=FP32_TOL, atol=FP32_TOL)
        return outs(tr), ts.decode_gemm_outputs

    toks_fifo, outs_fifo = run(False)
    toks_qos, outs_qos = run(True)
    assert toks_qos == toks_fifo
    assert len(outs_qos) == len(outs_fifo) > 0
    for a, b in zip(outs_fifo, outs_qos):
        assert torch.equal(a, b)


def test_deadline_misses_are_counted():
    js, ts = tenanted(specs=[("t", QosClass("t", deadline_s=0.0),
                              JaxQosClass("t", deadline_s=0.0), None)])
    jr, tr = both_requests([(2, "t", 0, 3)])
    submit_all(js, jr)
    submit_all(ts, tr)
    jst, stats = js.run(), ts.run()
    assert_same_stats(jst, stats)
    tst = stats.tenants["t"]
    assert tst.deadline_misses == 2 and tst.deadline_hits == 0
    assert tst.deadline_attainment == 0.0


def test_tenant_stats_attainment_empty():
    assert TenantStats().deadline_attainment == \
        jax_serving.TenantStats().deadline_attainment == 1.0
