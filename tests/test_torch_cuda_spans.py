"""The layer spans of the CNN path on the card: in a profiler session
that records the host, every ``gemm`` span is mirrored as a
``record_function`` that encloses the launch of its K1 kernel (matched by
correlation id), and the program's own stamps of each span agree with
the profiler's stamps of its mirror; in a session of device activity
alone the spans are recorded, none is mirrored, and their CUDA events
give each ``im2col`` and ``gemm`` span a stretch of the stream.

Every test here needs a card (marker ``requires_cuda``) and skips without
one.  On a machine with a card, and without JAX, run them as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_spans.py
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import PAPER_CNNS
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.obs import trace

pytestmark = pytest.mark.requires_cuda

CFG = PAPER_CNNS["CIFAR_Alex+"]
FRAMES = 256
#: the program stamps a span inside its mirror: start after the
#: ``record_function`` has entered, end before it exits, each on the
#: profiler's clock.  The gap on either side is that call's host cost.
MIRROR_SLACK_S = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def recorder():
    tr = trace.profiled_tracer()
    tr.clear()
    yield tr
    tr.clear()


def _forward(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    params = init_cnn(CFG, g, device=cuda)
    x = torch.randn(FRAMES, CFG.input_hw, CFG.input_hw, CFG.cin,
                    device=cuda, generator=g)
    cnn_forward(CFG, params, x, device=cuda)     # warm: K1 built, loaded
    torch.cuda.synchronize()
    return lambda: cnn_forward(CFG, params, x, device=cuda)


def _profiled(run, activities, tmp_path):
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


def test_mirrored_gemm_spans_enclose_their_k1_launches(cuda, recorder,
                                                        tmp_path):
    run = _forward(cuda)
    data = _profiled(run, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     tmp_path)
    events = data["traceEvents"]
    base = data["baseTimeNanoseconds"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "tiled_mm" in e["name"]]
    mirrors = sorted((e for e in events if e.get("cat") == "user_annotation"
                      and e["name"] == "gemm"), key=lambda e: e["ts"])
    assert len(k1) == len(mirrors) == 5
    for kernel in k1:
        launch = launches[kernel["args"]["correlation"]]
        inside = [m for m in mirrors if m["ts"] <= launch["ts"]
                  and launch["ts"] + launch["dur"] <= m["ts"] + m["dur"]]
        assert len(inside) == 1, kernel["name"]

    spans = recorder.events()
    assert not trace.validate_events(spans)
    for name in sorted(trace.SPAN_NAMES):
        ours = [e for e in spans if e.kind == name]
        theirs = sorted((e for e in events
                         if e.get("cat") == "user_annotation"
                         and e["name"] == name), key=lambda e: e["ts"])
        assert len(ours) == len(theirs), name
        for span, mirror in zip(ours, theirs):
            start = (mirror["ts"] * 1e3 + base) * 1e-9
            end = start + mirror["dur"] * 1e-6
            assert abs(span.ts - start) <= MIRROR_SLACK_S, name
            assert abs(span.ts + span.dur - end) <= MIRROR_SLACK_S, name


def test_device_only_session_records_spans_and_mirrors_none(
        cuda, recorder, tmp_path, monkeypatch):
    run = _forward(cuda)

    def no_mirror(name, *args, **kwargs):
        raise AssertionError(f"span {name!r} mirrored in a session of "
                             f"device activity alone")
    monkeypatch.setattr(trace, "record_function", no_mirror)
    data = _profiled(lambda: [run() for _ in range(3)],
                     [ProfilerActivity.CUDA], tmp_path)
    assert not [e for e in data["traceEvents"]
                if e.get("cat") == "user_annotation"]
    forwards = trace.profiled_forwards(3)
    assert forwards is not None
    for forward, spans in forwards:
        assert forward.tags.get("uploads", 0) == 0
        assert forward.tags["im2col_launches"] == 3
        assert forward.tags["launches"] == 5
        stretches = {k: [e.stream_ms() for e in spans if e.kind == k]
                     for k in ("im2col", "gemm")}
        assert len(stretches["im2col"]) == 3 and len(stretches["gemm"]) == 5
        assert all(ms > 0 for v in stretches.values() for ms in v)
        assert all(e.stream is None for e in spans
                   if e.kind not in ("im2col", "gemm"))
