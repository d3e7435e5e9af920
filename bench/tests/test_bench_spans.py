"""The eight readers of the program's spans (``host_ms``, ``host_wait_ms``,
``im2col_stream_ms``, ``gemm_stream_ms`` of each CNN cell) on a synthetic
profiled recorder: what each reads from the device window's forwards, and
None where the recorder holds fewer forwards, has dropped any, holds no
CUDA events, or where the program has no spans to read (the parent of
the change that brought them)."""

import pytest

import bench_testkit as tk
from benchkit.manifest import Bench
from benchkit.readers import Reading
from repro_torch.obs import trace

SUFFIXES = ("cnn", "cnn_b1024")
READERS = ("host_ms", "host_wait_ms", "im2col_stream_ms", "gemm_stream_ms")


class _Event:
    """A CUDA event's stand-in: ``elapsed_time`` from stamps in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def _span(kind, ts, dur, sid, parent, batch, stream_ms=None, **tags):
    stream = None if stream_ms is None else (_Event(0.0), _Event(stream_ms))
    return trace.TraceEvent(ts, kind, "MainThread", dur,
                            dict(tags, id=sid, parent=parent, batch=batch),
                            stream=stream)


def _forwards(n, host_s=(3e-3, 4e-3, 5e-3), cuda=True):
    """``n`` forwards, the i-th taking ``host_s[i % 3]`` on the host, each
    with two im2col spans (a 1 ms and a 2 ms stretch of the stream; the
    first's upload waits 0.5 ms) and a gemm (0.25 ms)."""
    out, sid = [], 0
    for i in range(n):
        t = 10.0 * i
        root = sid = sid + 1
        spans = [_span("cnn.forward", t, host_s[i % 3], root, None, root)]
        for j, ms in enumerate((1.0, 2.0)):
            sid += 1
            spans.append(_span("im2col", t + j, 1e-4, sid, root, root,
                               ms if cuda else None))
            if j == 0:
                sid += 1
                spans.append(_span("im2col.upload", t, 5e-4, sid, sid - 1,
                                   root, blocks=True))
        sid += 1
        spans.append(_span("gemm", t + 3, 1e-4, sid, root, root,
                           0.25 if cuda else None))
        out += spans
    return out


@pytest.fixture
def recorder(monkeypatch):
    def install(events, capacity=1 << 16):
        tr = trace.Tracer(capacity=capacity)
        for e in events:
            tr.record(e)
        monkeypatch.setattr(trace, "_profiled", tr)
        return tr
    return install


def _read(name, batches):
    bench = Bench(tk.ROOT)
    r = Reading(config={}, traffic={}, driver=None, window_s=1.0,
                busy_s=0.5, batches=batches, layer_batches=1, by_stack={})
    return bench.reader(name).read(r)


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_readers_read_the_device_window_s_forwards(recorder, suffix):
    # 3 forwards in the device window, then 2 of the later windows
    recorder(_forwards(5, host_s=(3e-3, 4e-3, 9e-3)))
    assert _read(f"host_ms.{suffix}", 3) == pytest.approx(4.0)
    assert _read(f"host_ms.{suffix}", 2) == pytest.approx(3.5)
    assert _read(f"host_wait_ms.{suffix}", 3) == pytest.approx(0.5)
    assert _read(f"im2col_stream_ms.{suffix}", 3) == pytest.approx(3.0)
    assert _read(f"gemm_stream_ms.{suffix}", 3) == pytest.approx(0.25)


@pytest.mark.parametrize("name", [f"{r}.{s}" for r in READERS
                                  for s in SUFFIXES])
def test_readers_find_nothing_in_a_short_or_dropping_recorder(recorder,
                                                               name):
    recorder(_forwards(2))
    assert _read(name, 3) is None
    assert _read(name, 0) is None
    tr = recorder(_forwards(3), capacity=len(_forwards(3)) - 1)
    assert _read(name, 2) is None
    assert tr.dropped == 1


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_stream_readers_need_the_cuda_events(recorder, suffix):
    recorder(_forwards(3, cuda=False))
    assert _read(f"im2col_stream_ms.{suffix}", 3) is None
    assert _read(f"gemm_stream_ms.{suffix}", 3) is None
    assert _read(f"host_ms.{suffix}", 3) == pytest.approx(4.0)


@pytest.mark.parametrize("name", [f"{r}.{s}" for r in READERS
                                  for s in SUFFIXES])
def test_readers_find_nothing_in_a_program_without_spans(recorder,
                                                           monkeypatch,
                                                           name):
    recorder(_forwards(3))
    monkeypatch.delattr(trace, "profiled_forwards")
    assert _read(name, 3) is None
