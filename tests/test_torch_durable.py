"""The port's durable serving (``repro_torch.soc.durable`` and the
journal, snapshots, restore and drain of ``repro_torch.core.serving``)
against ``repro``'s on the CPU.

Every test of ``tests/test_durable.py`` runs on ``repro``'s server and the
port's, built by ``tests/test_torch_serving.py::servers`` over one reduced
config with ``repro``'s weights carried across, at the same crash points:

* each request's tokens after restore are bitwise the uninterrupted run's
  (``repro``'s, which the port's uninterrupted run equals);
* the ``ServeStats`` / ``TenantStats`` counters are equal on both sides,
  ``tokens_out``, ``replayed_tokens``, ``replayed_jobs``, ``snapshots``
  and ``restores`` among them, and so are the FairShare virtual times;
* the journals are byte for byte equal, and each package scans the
  other's.

A crashed server's snapshot writer is joined before the restore: a killed
process's writer dies with it, while a ``SimulatedCrash`` leaves the
thread running in this process.  The SIGTERM test runs a port-only child
on the CPU.  Tolerance: bitwise tokens, exact counters."""

import json
import os
import signal
import struct
import subprocess
import sys
import textwrap
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.core import serving as jax_serving
from repro.engines import get_engine as jax_get_engine
from repro.obs import FlightRecorder as JaxFlightRecorder
from repro.obs import Tracer as JaxTracer
from repro.quant import QuantizedEngine as JaxQuantizedEngine
from repro.soc import AdmissionRejected as JaxAdmissionRejected
from repro.soc import CrashPlan as JaxCrashPlan
from repro.soc import Durability as JaxDurability
from repro.soc import HealthPolicy as JaxHealthPolicy
from repro.soc import QosClass as JaxQosClass
from repro.soc import RequestJournal as JaxJournal
from repro.soc import RestoreMismatch as JaxRestoreMismatch
from repro.soc import SimulatedCrash as JaxSimulatedCrash
from repro.soc import SynergyRuntime as JaxRuntime
from repro.soc import Tenant as JaxTenant
from repro.soc.durable import array_to_meta as jax_array_to_meta
from repro.soc.durable import load_snapshot as jax_load_snapshot
from repro.soc.durable import meta_to_array as jax_meta_to_array
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.serving import Request, SynergyServer
from repro_torch.engines import get_engine
from repro_torch.obs import (FlightRecorder, MetricsRegistry, Tracer,
                             render_prometheus)
from repro_torch.quant import QuantizedEngine
from repro_torch.soc import (AdmissionRejected, CrashPlan, Durability,
                             HealthPolicy, QosClass, RequestJournal,
                             RestoreMismatch, SimulatedCrash, SynergyRuntime,
                             Tenant)
from repro_torch.soc.durable import (array_to_meta, load_snapshot,
                                     meta_to_array)
from test_torch_serving import (_jax_decode, assert_same_stats, outs,
                                servers, submit_all)

_HDR = struct.Struct("<II")

#: the durability counters, beside test_torch_serving's COUNTERS
DURABLE_COUNTERS = ("tokens_out", "replayed_tokens", "replayed_jobs",
                    "snapshots", "restores")

BASE = dict(slots=2, max_len=32, prefill_len=4)


class _JaxServer(jax_serving.SynergyServer):
    """``repro``'s server on the shared jitted ``decode_step`` — also
    inside ``restore``, which replays before a caller could swap it."""

    def __init__(self, cfg, params, **kw):
        super().__init__(cfg, params, **kw)
        self._decode = _jax_decode(cfg)


def _reqs(n=4, new=5, tenant=None):
    """The reference test's requests for each server: (repro's, port's)."""
    jr, tr = [], []
    for i in range(n):
        t = tenant(i) if callable(tenant) else tenant
        toks = np.arange(4, dtype=np.int32) + i
        jr.append(jax_serving.Request(i, jnp.asarray(toks),
                                      max_new_tokens=new, tenant=t))
        tr.append(Request(i, torch.from_numpy(toks.copy()),
                          max_new_tokens=new, tenant=t))
    return jr, tr


def _streams(reqs):
    return {r.rid: list(r.out) for r in reqs}


def _tenants():
    """The two-tenant mix of the reference's chunked sweep, per side."""
    return ({"tenants": [
                JaxTenant("acme", JaxQosClass("interactive", priority=1,
                                              weight=2.0)),
                JaxTenant("bulk", JaxQosClass("bulk", priority=0,
                                              weight=1.0))]},
            {"tenants": [
                Tenant("acme", QosClass("interactive", priority=1,
                                        weight=2.0)),
                Tenant("bulk", QosClass("bulk", priority=0, weight=1.0))]})


def _acme_bulk(i):
    return "acme" if i % 2 == 0 else "bulk"


def reference(n=4, tenant=None, jax_kw=(), torch_kw=(), **kw):
    """The uninterrupted run on both servers: equal streams and counters;
    returns (streams, repro's server, the port's)."""
    js, ts = servers(jax_kw=jax_kw, torch_kw=torch_kw, **{**BASE, **kw})
    jr, tr = _reqs(n, tenant=tenant)
    submit_all(js, jr)
    submit_all(ts, tr)
    js.run()
    ts.run()
    assert outs(tr) == outs(jr)
    assert_same_stats(js.stats, ts.stats)
    return _streams(jr), js, ts


def durable_pair(tmp_path, crash_at=None, snapshot_every=3, jax_kw=(),
                 torch_kw=(), durable_kw=(), **kw):
    """Durable servers on both sides, each with its own directory."""
    jkw, tkw = dict(jax_kw), dict(torch_kw)
    jkw["durable"] = JaxDurability(str(tmp_path / "repro"),
                                   snapshot_every=snapshot_every,
                                   **dict(durable_kw))
    tkw["durable"] = Durability(str(tmp_path / "port"),
                                snapshot_every=snapshot_every,
                                **dict(durable_kw))
    if crash_at is not None:
        jkw["crash_plan"] = JaxCrashPlan(at_step=crash_at)
        tkw["crash_plan"] = CrashPlan(at_step=crash_at)
    return servers(jax_kw=jkw, torch_kw=tkw, **{**BASE, **kw})


def crash_both(js, ts, jr, tr):
    """Serve until each side's CrashPlan fires, then join each crashed
    server's snapshot writer (as a killed process's would have died)."""
    with pytest.raises(JaxSimulatedCrash):
        submit_all(js, jr)
        js.run()
    with pytest.raises(SimulatedCrash):
        submit_all(ts, tr)
        ts.run()
    js._ck.wait()
    ts._ck.wait()


def restore_both(js, ts, jax_kw=(), torch_kw=(), **kw):
    """``restore`` on each side from its crashed server's directory, with
    that server's construction (``kw`` to both)."""
    base = dict(slots=ts.slots, max_len=ts.max_len,
                prefill_len=ts.prefill_len, **kw)
    j2 = _JaxServer.restore(js.cfg, js.params, durable=js.durable,
                            prefill_cnn=js.prefill_cnn, **base,
                            **dict(jax_kw))
    t2 = SynergyServer.restore(ts.cfg, ts.params, durable=ts.durable,
                               prefill_cnn=ts.prefill_cnn,
                               cnn_params=ts._cnn_params,
                               decode_weight=ts._decode_w, device="cpu",
                               **base, **dict(torch_kw))
    return j2, t2


def assert_durable_stats(jst, tst):
    assert_same_stats(jst, tst)
    for name in DURABLE_COUNTERS:
        assert getattr(tst, name) == getattr(jst, name), name


def assert_restored(srv, reqs, ref, what):
    got = {rid: list(r.out) for rid, r in srv.restored_requests.items()}
    for r in reqs:
        assert got.get(r.rid, list(r.out)) == ref[r.rid], (what, r.rid)


def keystone(tmp_path, crash_at, *, ref, n=4, tenant=None, jax_kw=(),
             torch_kw=(), **kw):
    """Crash at ``crash_at`` on both sides, restore, finish, and assert
    the keystone: bitwise streams and exactly-once accounting, with equal
    counters and virtual times across the two packages."""
    js, ts = durable_pair(tmp_path, crash_at, jax_kw=jax_kw,
                          torch_kw=torch_kw, **kw)
    jr, tr = _reqs(n, tenant=tenant)
    crash_both(js, ts, jr, tr)
    kw.pop("snapshot_every", None)
    j2, t2 = restore_both(js, ts, jax_kw=jax_kw, torch_kw=torch_kw, **kw)
    assert_durable_stats(j2.stats, t2.stats)
    j2.run()
    t2.run()
    assert_restored(j2, jr, ref, f"repro crash_at={crash_at}")
    assert_restored(t2, tr, ref, f"port crash_at={crash_at}")
    assert_durable_stats(j2.stats, t2.stats)
    assert t2._fair.snapshot() == j2._fair.snapshot()
    assert (t2.stats.tokens_out + t2.stats.replayed_tokens
            == sum(max(0, len(v) - 1) for v in ref.values()))
    assert t2.stats.restores == 1
    return (js, ts), (j2, t2)


# ------------------------------------------------------------- journal

def _scan_both(p):
    """The port's scan and repro's scan of one file must agree."""
    got = RequestJournal.scan(p)
    assert got == JaxJournal.scan(p)
    return got


def test_journal_roundtrip_and_offsets(tmp_path):
    p = tmp_path / "j.bin"
    j = RequestJournal(p)
    recs = [{"t": "submit", "rid": 1, "tok": [1, 2, 3]},
            {"t": "admit", "wave": [[1, 0]]},
            {"t": "tok", "e": [[1, 0, 42]]}]
    offs = [j.append(r) for r in recs]
    assert offs == sorted(offs) and j.offset() == offs[-1]
    j.close()
    j.close()                                    # idempotent
    got, end, torn = _scan_both(p)
    assert got == recs and end == offs[-1] and not torn
    # suffix scan from a stored boundary picks up exactly the tail
    tail, _, _ = RequestJournal.scan(p, start=offs[0])
    assert tail == recs[1:]
    # byte for byte repro's record format
    jp = tmp_path / "repro.bin"
    jj = JaxJournal(jp)
    for r in recs:
        jj.append(r)
    jj.close()
    assert p.read_bytes() == jp.read_bytes()


def test_journal_truncates_torn_tail(tmp_path):
    p = tmp_path / "j.bin"
    j = RequestJournal(p)
    j.append({"t": "submit", "rid": 7, "tok": [9]})
    good = j.offset()
    j.close()
    with open(p, "ab") as f:                     # crash mid-append
        f.write(_HDR.pack(100, 0) + b"only-part-of-the-payload")
    recs, end, torn = _scan_both(p)
    assert torn and end == good and len(recs) == 1
    j2 = RequestJournal(p)                       # reopen truncates
    assert j2.truncated_bytes > 0
    assert os.path.getsize(p) == good
    j2.append({"t": "tok", "e": [[7, 0, 1]]})    # appends land cleanly
    j2.close()
    recs, _, torn = _scan_both(p)
    assert not torn and [r["t"] for r in recs] == ["submit", "tok"]


def test_journal_rejects_corrupt_crc(tmp_path):
    p = tmp_path / "j.bin"
    j = RequestJournal(p)
    j.append({"t": "submit", "rid": 1, "tok": [1]})
    j.append({"t": "tok", "e": [[1, 0, 5]]})
    j.close()
    raw = bytearray(p.read_bytes())
    raw[-1] ^= 0xFF                              # flip a payload byte
    p.write_bytes(bytes(raw))
    recs, _, torn = _scan_both(p)
    assert torn and len(recs) == 1               # stops AT the bad record


def test_meta_array_roundtrip():
    meta = {"a": 1, "b": [1.5, None, "x"], "c": {"d": True}}
    assert array_to_meta(meta_to_array(meta)) == meta
    assert np.array_equal(meta_to_array(meta), jax_meta_to_array(meta))
    assert jax_array_to_meta(meta_to_array(meta)) == meta


def test_crash_plan_due():
    plan = CrashPlan(at_step=3)
    assert not plan.due(2) and plan.due(3) and plan.due(7)


def test_journals_are_byte_identical_and_cross_scan(tmp_path):
    """One uninterrupted durable run per side: the two journals hold the
    same bytes, and the port's scan of repro's journal gives repro's
    records."""
    js, ts = durable_pair(tmp_path, snapshot_every=0)
    jr, tr = _reqs()
    submit_all(js, jr)
    submit_all(ts, tr)
    js.run()
    ts.run()
    assert outs(tr) == outs(jr)
    jpath, tpath = js.durable.journal_path, ts.durable.journal_path
    js._journal.close()
    ts._journal.close()
    recs, end, torn = RequestJournal.scan(jpath)
    assert (recs, end, torn) == JaxJournal.scan(jpath)
    assert not torn and {r["t"] for r in recs} == {"submit", "admit",
                                                   "first", "tok"}
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


# ------------------------------------------- keystone: crash → restore

def test_crash_restore_blocking_sweep(tmp_path):
    ref, _, _ = reference()
    for crash_at in (1, 2, 5, 9):
        keystone(tmp_path / f"at{crash_at}", crash_at, ref=ref)


def test_crash_restore_chunked_tenants_sweep(tmp_path):
    """Chunked prefill + 2 tenants: streams stay bitwise, the replayed
    admissions charge FairShare identically (restored virtual times ==
    the uninterrupted run's), and nothing double-books."""
    jkw, tkw = _tenants()
    kw = dict(prefill_chunk_macs=2_000)
    ref, jref, tref = reference(5, tenant=_acme_bulk, jax_kw=jkw,
                                torch_kw=tkw, **kw)
    ref_vt = jref._fair.snapshot()
    assert tref._fair.snapshot() == ref_vt
    for crash_at in (1, 5, 8, 13):
        _, (j2, t2) = keystone(
            tmp_path / f"at{crash_at}", crash_at, ref=ref, n=5,
            tenant=_acme_bulk, jax_kw=jkw, torch_kw=tkw, snapshot_every=4,
            **kw)
        assert t2._fair.snapshot() == ref_vt
        # replay recomputes state, it does not re-serve: per-tenant
        # tokens stay <= the uninterrupted totals
        for name, ts in t2.stats.tenants.items():
            assert ts.tokens_out <= tref.stats.tenants[name].tokens_out


def test_restore_survives_torn_journal_tail(tmp_path):
    ref, _, _ = reference()
    js, ts = durable_pair(tmp_path, crash_at=5)
    jr, tr = _reqs()
    crash_both(js, ts, jr, tr)
    for srv in (js, ts):
        with open(srv.durable.journal_path, "ab") as f:  # die mid-append
            f.write(_HDR.pack(64, 123456) + b"torn")
    j2, t2 = restore_both(js, ts)
    assert t2._journal.truncated_bytes == j2._journal.truncated_bytes > 0
    j2.run()
    t2.run()
    for rid, r in t2.restored_requests.items():
        assert list(r.out) == ref[rid]
    assert_restored(j2, jr, ref, "repro")
    assert_durable_stats(j2.stats, t2.stats)


def _forge_first_token(path):
    recs, _, _ = RequestJournal.scan(path)
    forged, done = [], False
    for rec in recs:
        if not done and rec["t"] == "tok":
            rec = dict(rec, e=[[rid, slot, (tok + 1) % 128]
                               for rid, slot, tok in rec["e"]])
            done = True
        forged.append(rec)
    assert done
    with open(path, "wb") as f:
        for rec in forged:
            payload = json.dumps(rec, separators=(",", ":")).encode()
            f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
            f.write(payload)


def test_restore_mismatch_on_forged_journal(tmp_path):
    """A journal whose recorded token disagrees with the recomputation
    raises RestoreMismatch (and flight-dumps) on both sides — serving
    must not resume from state that is not the crashed process's."""
    js, ts = durable_pair(tmp_path / "w", crash_at=6, snapshot_every=0)
    jr, tr = _reqs()
    crash_both(js, ts, jr, tr)
    _forge_first_token(js.durable.journal_path)
    _forge_first_token(ts.durable.journal_path)
    jtr, ttr = JaxTracer(capacity=256), Tracer(capacity=256)
    jfr = JaxFlightRecorder(jtr, dir=str(tmp_path / "jdumps"))
    tfr = FlightRecorder(ttr, dir=str(tmp_path / "tdumps"))
    with pytest.raises(JaxRestoreMismatch) as jerr:
        restore_both(js, ts, jax_kw={"tracer": jtr,
                                     "flight_recorder": jfr})
    with pytest.raises(RestoreMismatch) as terr:
        SynergyServer.restore(ts.cfg, ts.params, durable=ts.durable,
                              cnn_params=ts._cnn_params,
                              decode_weight=ts._decode_w, device="cpu",
                              tracer=ttr, flight_recorder=tfr, **BASE)
    assert terr.value.expected == jerr.value.expected
    assert terr.value.got == jerr.value.got
    assert len(tfr.dumps) == len(jfr.dumps) == 1
    dump = json.loads(open(tfr.dumps[0]).read())
    assert dump["reason"] == "restore_mismatch"


# ------------------------------------ snapshot state: field round-trips

def test_pool_state_round_trips_field_by_field(tmp_path):
    """Calibrator EMA, learned engine rates, and health baselines ride
    the snapshot: a restore into a FRESH pool starts with the crashed
    pool's state, field by field; the calibrator states equal repro's."""
    pol = HealthPolicy(alpha=0.5, quarantine_below=0.0, readmit_above=0.0)
    jpol = JaxHealthPolicy(alpha=0.5, quarantine_below=0.0,
                           readmit_above=0.0)
    kw = dict(max_inflight=0, cnn="tiny")

    def pools(tag):
        return (JaxRuntime([JaxQuantizedEngine(jax_get_engine("xla"),
                                               name="dur-int8"), "F-PE"],
                           name=f"dur-{tag}",
                           rates_path=str(tmp_path / f"jr-{tag}.json"),
                           health=jpol),
                SynergyRuntime([QuantizedEngine(get_engine("cuda-tiled"),
                                                name="dur-int8"), "F-PE"],
                               name=f"dur-{tag}", device="cpu",
                               rates_path=str(tmp_path / f"tr-{tag}.json"),
                               health=pol))

    jrt, trt = pools("a")
    with jrt, trt:
        js, ts = durable_pair(tmp_path, snapshot_every=0,
                              durable_kw={"async_snapshots": False},
                              jax_kw={"runtime": jrt},
                              torch_kw={"runtime": trt}, **kw)
        jr, tr = _reqs(3)
        submit_all(js, jr)
        submit_all(ts, tr)
        for _ in range(4):
            js.step()
            ts.step()
        js.snapshot()
        ts.snapshot()
        want = {"repro": jrt.state_snapshot(), "port": trt.state_snapshot()}
        cal = {"repro": js._calibration_engine().calibrator.export_state(),
               "port": ts._calibration_engine().calibrator.export_state()}
        assert cal["port"] and want["port"]["macs_per_s"]
        assert cal["port"] == cal["repro"]
    jrt2, trt2 = pools("b")
    with jrt2, trt2:
        js2, ts2 = servers(jax_kw={"runtime": jrt2},
                           torch_kw={"runtime": trt2}, **BASE, **kw)
        _, jflat = jax_load_snapshot(JaxCheckpointer(js.durable.snapshot_dir))
        _, tflat = load_snapshot(Checkpointer(ts.durable.snapshot_dir))
        js2._apply_snapshot(jflat)
        ts2._apply_snapshot(tflat)
        for side, rt, srv in (("repro", jrt2, js2), ("port", trt2, ts2)):
            got = rt.state_snapshot()
            assert got["macs_per_s"] == want[side]["macs_per_s"]
            for name, h in want[side]["health"].items():
                assert got["health"][name] == h
            assert (srv._calibration_engine().calibrator.export_state()
                    == cal[side])


def test_crash_restore_with_runtime_pool(tmp_path):
    """End-to-end over a real pool (int8 + F-PE): the restored servers
    finish every request with the reference streams, and replay books
    runtime work into replayed_jobs, not runtime_jobs, alike."""
    kw = dict(max_inflight=1, cnn="tiny")

    # the port's int8 engine wraps ``torch``, as in the QoS shed test: on
    # the CPU its cost model ranks against F-PE as repro's xla one does, so
    # both pools give the int8 engine the same panels
    def pools(tag):
        return (JaxRuntime([JaxQuantizedEngine(jax_get_engine("xla"),
                                               name=f"ci8-{tag}"), "F-PE"],
                           name=f"dur-{tag}"),
                SynergyRuntime([QuantizedEngine(get_engine("torch"),
                                                name=f"ci8-{tag}"), "F-PE"],
                               name=f"dur-{tag}", device="cpu"))

    jrt, trt = pools("ref")
    with jrt, trt:
        ref, _, _ = reference(3, jax_kw={"runtime": jrt},
                              torch_kw={"runtime": trt}, **kw)
    jrt, trt = pools("x")
    with jrt, trt:
        js, ts = durable_pair(tmp_path, crash_at=4, jax_kw={"runtime": jrt},
                              torch_kw={"runtime": trt}, **kw)
        jr, tr = _reqs(3)
        crash_both(js, ts, jr, tr)
    jrt2, trt2 = pools("y")
    with jrt2, trt2:
        j2, t2 = restore_both(js, ts, jax_kw={"runtime": jrt2},
                              torch_kw={"runtime": trt2},
                              max_inflight=1)
        assert t2.stats.replayed_tokens > 0
        assert t2.stats.replayed_jobs > 0
        assert_durable_stats(j2.stats, t2.stats)
        j2.run()
        t2.run()
    assert_restored(j2, jr, ref, "repro")
    assert_restored(t2, tr, ref, "port")
    for rid, r in t2.restored_requests.items():
        assert list(r.out) == ref[rid]
    assert_durable_stats(j2.stats, t2.stats)
    assert (t2.stats.tokens_out + t2.stats.replayed_tokens
            == sum(max(0, len(v) - 1) for v in ref.values()))


# --------------------------------------------------- no double counting

def test_replay_does_not_double_count(tmp_path):
    """Restored counters seed from the snapshot and replay books ONLY
    replayed_tokens — fresh tokens over (crashed run, restored run)
    equal one uninterrupted run exactly, on both sides."""
    ref, jref, tref = reference()
    (_, _), (j2, t2) = keystone(tmp_path, 7, ref=ref, snapshot_every=2)
    assert (t2.stats.tokens_out + t2.stats.replayed_tokens
            == tref.stats.tokens_out == jref.stats.tokens_out)
    for r in t2.restored_requests.values():
        assert len(r.out) == r.max_new_tokens and r.done_at is not None
    assert t2.stats.snapshots >= 1 and t2.stats.restores == 1


# -------------------------------------------------------- drain / close

def test_close_drains_snapshots_and_rejects(tmp_path):
    js, ts = durable_pair(tmp_path, snapshot_every=0)
    jr, tr = _reqs(2)
    for srv, reqs in ((js, jr), (ts, tr)):
        submit_all(srv, reqs)
        srv.step()                               # admit the wave
        srv.close()
        # LIVE generations ran to completion (close stops admission only)
        assert all(len(r.out) == r.max_new_tokens for r in reqs)
        assert srv._journal._f.closed
    assert outs(tr) == outs(jr)
    assert_durable_stats(js.stats, ts.stats)
    with pytest.raises(JaxAdmissionRejected):
        js.submit(jax_serving.Request(99, jnp.arange(4, dtype=jnp.int32),
                                      max_new_tokens=2))
    with pytest.raises(AdmissionRejected):
        ts.submit(Request(99, torch.arange(4, dtype=torch.int32),
                          max_new_tokens=2))
    assert Checkpointer(ts.durable.snapshot_dir).latest_step() \
        == JaxCheckpointer(js.durable.snapshot_dir).latest_step() \
        is not None


def test_close_snapshot_preserves_pending_for_restore(tmp_path):
    """Requests still queued when the deadline cuts close() short are in
    the final snapshot: restore picks them up and serves them with the
    reference streams (graceful handoff, not loss)."""
    ref, _, _ = reference(3, slots=1)
    js, ts = durable_pair(tmp_path, snapshot_every=0, slots=1)
    jr, tr = _reqs(3)
    for srv, reqs in ((js, jr), (ts, tr)):
        submit_all(srv, reqs)
        srv.step()                               # admit only the first
        srv.close(deadline_s=0.0)                # deadline: stop NOW
    j2, t2 = restore_both(js, ts)
    j2.run()
    t2.run()
    for rid, r in t2.restored_requests.items():
        assert list(r.out) == ref[rid]
    assert len(t2.restored_requests) == len(j2.restored_requests) == 3
    assert_durable_stats(j2.stats, t2.stats)


def test_request_drain_stops_run_loop(tmp_path):
    js, ts = durable_pair(tmp_path, snapshot_every=0)
    jr, tr = _reqs(2)
    for srv, reqs in ((js, jr), (ts, tr)):
        submit_all(srv, reqs)
        srv.step()                               # admit the wave
        srv.request_drain()
        srv.run()
        assert all(len(r.out) == r.max_new_tokens for r in reqs)
        assert srv._journal._f.closed            # close() ran
    assert outs(tr) == outs(jr)
    assert_durable_stats(js.stats, ts.stats)


_SIGTERM_CHILD = textwrap.dedent("""
    import os, signal, sys, threading
    import torch
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.core.serving import Request, SynergyServer
    from repro_torch.models import init_model
    from repro_torch.soc import Durability, install_sigterm_drain

    cfg = reduced(ARCHS["granite-3-2b"], n_layers=2, d_model=32,
                  n_heads=2, d_ff=64, vocab=128)
    params = init_model(cfg, 0, device="cpu")
    srv = SynergyServer(cfg, params, slots=2, max_len=32, prefill_len=4,
                        device="cpu",
                        durable=Durability(sys.argv[1], snapshot_every=0))
    install_sigterm_drain(srv)
    for i in range(60):
        srv.submit(Request(i, torch.arange(4, dtype=torch.int32) + i,
                           max_new_tokens=40))
    threading.Timer(0.2, os.kill,
                    (os.getpid(), signal.SIGTERM)).start()
    stats = srv.run(max_steps=100_000)
    print("DONE", stats.tokens_out, flush=True)
""")


def test_sigterm_drains_to_clean_snapshot(tmp_path):
    """SIGTERM mid-run ends in a clean snapshot + closed journal, not a
    dead process: a port-only child on the CPU."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep \
        + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _SIGTERM_CHILD, str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DONE" in out.stdout
    assert Checkpointer(str(tmp_path / "snapshots")).latest_step() \
        is not None
    # the journal tail is intact (clean close, no torn record)
    _, _, torn = RequestJournal.scan(str(tmp_path / "journal.bin"))
    assert not torn


# --------------------------------------------------------- observability

def test_trace_and_metrics_cover_durability(tmp_path):
    tr = Tracer(capacity=512)
    d = Durability(str(tmp_path), snapshot_every=2, async_snapshots=False)
    _, ts = servers(torch_kw={"durable": d, "tracer": tr}, **BASE)
    _, reqs = _reqs(2)
    submit_all(ts, reqs)
    ts.run()
    ts.close()
    kinds = {e.kind for e in tr.events()}
    assert {"snapshot", "drain"} <= kinds
    text = render_prometheus(server=ts, registry=MetricsRegistry())
    assert "repro_serve_snapshots_total" in text
    assert "repro_serve_replayed_tokens_total" in text
