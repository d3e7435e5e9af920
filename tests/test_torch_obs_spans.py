"""The layer spans of the port's CNN path (``repro_torch.obs.trace.span``)
on the CPU, on a CIFAR_Alex+ forward at batch 2: the span tree and its
``id`` / ``parent`` / ``batch`` tags, the six index-grid uploads a
forward and their bytes, nothing recorded and no ``record_function``
called while nothing records, ``validate_events`` on spans and orphans,
the chrome export's ``"X"`` spans on an absolute base and its merge into
a ``torch.profiler`` trace, the profiled recorder and its mirrors, the
test for a session that records the host's operations, a runtime's
panels on the same clock, and ``EVENT_KINDS`` still ``repro``'s."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.obs import trace as REPRO
from repro_torch.configs import PAPER_CNNS
from repro_torch.core.im2col import conv_out_shape
from repro_torch.core.synergy_mm import synergy_matmul
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.obs import trace as PORT
from repro_torch.soc import SynergyRuntime

CFG = PAPER_CNNS["CIFAR_Alex+"]
CHILDREN = {"im2col": "cnn.forward", "im2col.upload": "im2col",
            "gemm": "cnn.forward", "gemm.dispatch": "gemm",
            "gemm.launch": "gemm", "pool": "cnn.forward"}
COUNTS = {"cnn.forward": 1, "im2col": 3, "im2col.upload": 3, "gemm": 5,
          "gemm.dispatch": 5, "gemm.launch": 5, "pool": 3}
#: a span's program stamps against its mirror's: the record_function's
#: own enter and exit lie between them
MIRROR_SLACK_S = 5e-3


@pytest.fixture(scope="module")
def net():
    params = init_cnn(CFG, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, CFG.input_hw, CFG.input_hw, CFG.cin,
                    generator=torch.Generator().manual_seed(1))
    return params, x


@pytest.fixture
def recorder():
    rec = PORT.profiled_tracer()
    rec.clear()
    yield rec
    rec.clear()


def _forward(net):
    params, x = net
    return cnn_forward(CFG, params, x, device="cpu")


def _traced(net):
    tracer = PORT.Tracer()
    with PORT.trace_scope(tracer):
        _forward(net)
    return tracer, [e for e in tracer.events() if e.kind in PORT.SPAN_NAMES]


def _conv_shapes():
    shapes, _ = CFG.trace_shapes()
    return [(spec, h, w, c) for spec, h, w, c in shapes if spec[0] == "conv"]


def test_forward_spans_form_one_tree(net):
    _, spans = _traced(net)
    by_id = {e.tags["id"]: e for e in spans}
    assert len(by_id) == len(spans)
    assert {k: sum(e.kind == k for e in spans) for k in COUNTS} == COUNTS
    (forward,) = [e for e in spans if e.kind == "cnn.forward"]
    assert forward.tags["parent"] is None
    assert forward.tags["frames"] == 2 and forward.tags["net"] == CFG.name
    for e in spans:
        assert e.tags["batch"] == forward.tags["id"]
        assert e.track == forward.track
        if e is forward:
            continue
        parent = by_id[e.tags["parent"]]
        assert parent.kind == CHILDREN[e.kind]
        assert parent.ts <= e.ts and e.ts + e.dur <= parent.ts + parent.dur
    top = [e.kind for e in spans if e.tags["parent"] == forward.tags["id"]]
    assert top == ["im2col", "gemm", "pool"] * 3 + ["gemm", "gemm"]
    gemms = [e.tags for e in spans if e.kind == "gemm"]
    assert [g["name"] for g in gemms] == [
        f"{CFG.name}/{layer}" for layer in
        ("conv0", "conv2", "conv4", "fc6", "fc7")]
    assert all(g["engine"] == "torch" for g in gemms)
    im2cols = [e.tags for e in spans if e.kind == "im2col"]
    for tags, (spec, h, w, c) in zip(im2cols, _conv_shapes()):
        _, cout, k, s, p = spec
        oh, ow = conv_out_shape(h, w, k, k, s, p)
        assert (tags["kh"], tags["kw"], tags["stride"]) == (k, k, s)
        assert (tags["m"], tags["k"]) == (2 * oh * ow, k * k * c)


def test_forward_counts_six_uploads_and_their_bytes(net):
    _, spans = _traced(net)
    (forward,) = [e for e in spans if e.kind == "cnn.forward"]
    expect = 0
    for spec, h, w, _ in _conv_shapes():
        _, _, k, s, p = spec
        oh, ow = conv_out_shape(h, w, k, k, s, p)
        expect += 8 * (oh * k + ow * k)      # int64 row and column grids
    assert forward.tags["uploads"] == 6
    assert forward.tags["upload_bytes"] == expect
    uploads = [e for e in spans if e.kind == "im2col.upload"]
    assert [e.tags["uploads"] for e in uploads] == [2, 2, 2]
    assert all(e.tags["blocks"] for e in uploads)
    # CPU tensors take torch.matmul: K1 is never launched
    assert forward.tags["launches"] == 0
    assert all(e.stream is None for e in spans)


def test_nothing_records_with_no_tracer_and_no_profiler(net, recorder,
                                                         monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("called while nothing records")
    monkeypatch.setattr(PORT, "record_function", forbidden)
    monkeypatch.setattr(PORT, "_records_host_ops", forbidden)
    monkeypatch.setattr(PORT, "_Span", forbidden)
    assert PORT.get_default_tracer() is None
    assert not torch.autograd.profiler._is_profiler_enabled
    assert PORT.span("gemm", name="x", m=1) is PORT._OFF
    _forward(net)
    assert len(recorder) == 0


def test_validate_events_passes_spans_and_flags_an_orphan(net):
    tracer, spans = _traced(net)
    assert PORT.validate_events(tracer.events()) == []
    forward = next(e for e in spans if e.kind == "cnn.forward")
    orphans = [e for e in spans if e is not forward]
    errs = PORT.validate_events(orphans)
    assert len(errs) == 11           # every direct child of the forward
    assert all(f"parent #{forward.tags['id']} is not in the trace" in x
               for x in errs)
    gemm = next(e for e in spans if e.kind == "gemm")
    launch = next(e for e in spans if e.kind == "gemm.launch"
                  and e.tags["parent"] == gemm.tags["id"])
    moved = PORT.TraceEvent(gemm.ts + gemm.dur + 1e-3, launch.kind,
                            launch.track, launch.dur, launch.tags)
    errs = PORT.validate_events([forward, gemm, moved])
    assert errs == [f"span 'gemm.launch' #{launch.tags['id']} is not "
                    f"inside its parent #{gemm.tags['id']} ('gemm' on "
                    f"{gemm.track!r})"]
    bogus = PORT.TraceEvent(forward.ts, "layer", "t", 0.0, {})
    assert PORT.validate_events([bogus]) == [
        "unknown event kind 'layer' on 't'"]


def test_chrome_export_holds_x_spans_on_an_absolute_base(net, tmp_path):
    tracer, spans = _traced(net)
    path = tmp_path / "spans.json"
    tracer.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = data["otherData"]["baseTimeNanoseconds"]
    assert abs(base - time.time_ns()) < 60e9
    xs = [d for d in data["traceEvents"] if d.get("cat") in PORT.SPAN_NAMES]
    assert len(xs) == len(spans) and all(d["ph"] == "X" for d in xs)
    for d, e in zip(sorted(xs, key=lambda d: d["args"]["id"]),
                    sorted(spans, key=lambda e: e.tags["id"])):
        assert d["name"] == e.kind
        assert {"id", "parent", "batch"} <= set(d["args"])
        assert d["ts"] * 1e3 + base == pytest.approx(e.ts * 1e9, abs=1e3)
        assert d["dur"] == pytest.approx(e.dur * 1e6, abs=1e-3)
    back = [e for e in PORT.load_chrome_trace(str(path))
            if e.kind in PORT.SPAN_NAMES]
    assert sorted((e.kind, e.tags["id"], e.tags["parent"]) for e in back) \
        == sorted((e.kind, e.tags["id"], e.tags["parent"]) for e in spans)
    assert PORT.validate_events(back) == []


def test_a_profiled_forward_is_recorded_and_mirrored_on_one_clock(
        net, recorder, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward(net)
    prof_path = tmp_path / "profiler.json"
    prof.export_chrome_trace(str(prof_path))
    forwards = PORT.profiled_forwards(1)
    assert forwards is not None and PORT.profiled_forwards(2) is None
    forward, children = forwards[0]
    assert len(children) == sum(COUNTS.values()) - 1
    spans = recorder.events()
    data = json.loads(prof_path.read_text())
    base = data["baseTimeNanoseconds"]
    mirrors = [d for d in data["traceEvents"]
               if d.get("cat") == "user_annotation"
               and d["name"] in PORT.SPAN_NAMES]
    assert len(mirrors) == len(spans)
    for kind in COUNTS:
        ours = sorted((e for e in spans if e.kind == kind),
                      key=lambda e: e.ts)
        theirs = sorted((d for d in mirrors if d["name"] == kind),
                        key=lambda d: d["ts"])
        for e, d in zip(ours, theirs):
            start = (d["ts"] * 1e3 + base) * 1e-9
            assert e.ts == pytest.approx(start, abs=MIRROR_SLACK_S)
            assert e.ts + e.dur == pytest.approx(
                start + d["dur"] * 1e-6, abs=MIRROR_SLACK_S)
    # the program's export laid over the profiler's trace, one time base
    merged_path = tmp_path / "merged.json"
    recorder.export_chrome_trace(str(merged_path), beside=str(prof_path))
    merged = json.loads(merged_path.read_text())
    assert merged["baseTimeNanoseconds"] == base
    ours = [d for d in merged["traceEvents"]
            if d.get("ph") == "X" and d.get("cat") in PORT.SPAN_NAMES]
    assert len(ours) == len(spans)
    assert {d["pid"] for d in ours}.isdisjoint(
        {d.get("pid") for d in data["traceEvents"]})
    fwd = next(d for d in ours if d["name"] == "cnn.forward")
    mirror = next(d for d in mirrors if d["name"] == "cnn.forward")
    assert fwd["ts"] == pytest.approx(mirror["ts"], abs=1e6 * MIRROR_SLACK_S)


def _session_records_host(profiler):
    """Calls the test from a frame that holds ``profiler``, as a caller's
    ``with profile(...) as p:`` does."""
    return PORT._records_host_ops()


def test_host_ops_test_reads_the_running_session_s_use_cpu():
    """The test for "this session records the host's operations": the
    running session's ``use_cpu``, read off its object."""
    for use_cpu in (True, False):
        # a CPU build cannot open a session of device activity alone:
        # the object of one, as ``torch.profiler`` holds it while running
        session = torch.autograd.profiler.profile(use_kineto=True)
        session.use_cpu, session.entered = use_cpu, True
        assert _session_records_host(session) is use_cpu
        session.entered = False
        assert _session_records_host(session) is True    # none running
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _session_records_host(prof) is True


def test_counts_roll_up_to_the_batch_and_a_raise_is_tagged():
    tracer = PORT.Tracer()
    with PORT.trace_scope(tracer):
        with PORT.span("cnn.forward") as root:
            with PORT.span("gemm") as g, PORT.span("gemm.launch") as l:
                l.count(launches=2)
                g.count(launches=1)
            with pytest.raises(ValueError):
                with PORT.span("pool"):
                    raise ValueError
        with PORT.span("gemm"):
            pass
    spans = {e.tags["id"]: e for e in tracer.events()}
    assert root.tags["launches"] == 3
    kinds = {e.kind: e.tags for e in spans.values() if e.kind != "gemm"}
    assert kinds["gemm.launch"]["launches"] == 2
    assert kinds["pool"]["err"] == "ValueError"
    last = max(spans.values(), key=lambda e: e.tags["id"])
    assert last.tags["parent"] is None
    assert last.tags["batch"] == last.tags["id"]
    with pytest.raises(ValueError, match="SPAN_NAMES"):
        with PORT.trace_scope(tracer):
            PORT.span("conv")


def test_profiled_forwards_takes_the_first_n_forwards_and_their_spans(
        monkeypatch):
    def ev(kind, ts, sid, batch):
        return PORT.TraceEvent(ts, kind, "t", 1.0,
                               {"id": sid, "parent": None, "batch": batch})
    recorder = PORT.Tracer(capacity=6)
    for e in [ev("cnn.forward", 0.0, 1, 1), ev("gemm", 0.1, 2, 1),
              ev("cnn.forward", 1.0, 3, 3), ev("pool", 1.1, 4, 3),
              ev("gemm", 1.2, 5, 3), ev("cnn.forward", 2.0, 6, 6)]:
        recorder.record(e)
    monkeypatch.setattr(PORT, "_profiled", recorder)
    got = PORT.profiled_forwards(2)
    assert [(f.tags["id"], [c.tags["id"] for c in cs]) for f, cs in got] \
        == [(1, [2]), (3, [4, 5])]
    assert PORT.profiled_forwards(4) is None
    assert PORT.profiled_forwards(0) is None
    recorder.record(ev("pool", 2.1, 7, 6))       # the ring drops one
    assert PORT.profiled_forwards(1) is None


def test_runtime_panels_share_the_spans_clock():
    """A runtime's panel stamps, like the spans, are on the profiler's
    clock, inside the ``gemm`` span that submitted them."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(96, 40, generator=g)
    b = torch.randn(40, 24, generator=g)
    tracer = PORT.Tracer()
    before = PORT.profiler_clock()
    with PORT.trace_scope(tracer), \
            SynergyRuntime(["F-PE", "S-PE"], device="cpu") as rt, rt.scope():
        synergy_matmul(a, b, tile=16, name="split")
    after = PORT.profiler_clock()
    events = tracer.events()
    (gemm,) = [e for e in events if e.kind == "gemm"]
    assert gemm.tags["engine"] == "runtime"
    panels = [e for e in events if e.kind == "panel_start"]
    assert panels and PORT.validate_events(events) == []
    for p in panels:
        assert before <= p.ts and p.ts + p.dur <= after
        assert gemm.ts - 1e-6 <= p.ts <= gemm.ts + gemm.dur + 1e-6


def test_event_kinds_are_still_the_reference_s():
    assert PORT.EVENT_KINDS == REPRO.EVENT_KINDS
    assert not PORT.SPAN_NAMES & PORT.EVENT_KINDS
