"""The reduction of a profiler trace to device time by layer, busy time
and idle gaps, on synthetic chrome-trace events of the profiler's
format."""

import time

import pytest

import bench_testkit  # noqa: F401  (puts the harness on sys.path)
from benchkit import trace

PORT = "/ckpt/src/repro_torch/"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _events():
    """A window of 100 us: the harness span, two port frames, two
    launches (one from im2col, one from a GEMM) and their kernels, one
    kernel whose launch the trace lacks."""
    return [
        _x("user_annotation", trace.WINDOW_SPAN, 0, 100),
        _x("user_annotation", "bench.submit", 1, 60),
        _x("python_function", f"{PORT}models/cnn.py(10): cnn_forward",
           2, 50),
        _x("python_function", f"{PORT}core/im2col.py(40): im2col", 3, 10),
        _x("python_function", "/lib/torch/x.py(1): helper", 4, 2),
        _x("cpu_op", "aten::index", 4, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=7),
        _x("python_function",
           f"{PORT}core/synergy_mm.py(99): synergy_matmul", 20, 20),
        _x("cuda_driver", "cuLaunchKernelEx", 25, 1, correlation=8),
        _x("kernel", "gather", 10, 20, tid=7, correlation=7),
        _x("kernel", "gemm", 40, 30, tid=7, correlation=8),
        _x("gpu_memcpy", "copy", 90, 20, tid=7, correlation=99),
    ]


def test_attribute_ties_each_kernel_to_the_port_frames_that_launched_it():
    by = trace.attribute(_events())
    assert by[("models/cnn.py:cnn_forward", "core/im2col.py:im2col")] \
        == pytest.approx(20e-6)
    assert by[("models/cnn.py:cnn_forward",
               "core/synergy_mm.py:synergy_matmul")] == pytest.approx(30e-6)
    # clipped to the window's end; its launch is not in the trace
    assert by[None] == pytest.approx(10e-6)


def _device_only():
    """The device window's trace: CUDA activity alone, no host events."""
    return [e for e in _events() if e["cat"] in trace.DEVICE_CATS]


def test_device_time_reads_busy_and_top_ops_without_host_events():
    s = trace.device_time(_device_only())
    # every device interval of the trace: 20 + 30 + 20 us
    assert s["busy_s"] == pytest.approx(70e-6)
    assert dict(s["device_ops"]) == pytest.approx(
        {"gather": 20e-6, "gemm": 30e-6, "copy": 20e-6})
    overlapping = _device_only() + [_x("kernel", "gemm", 45, 10, tid=8)]
    assert trace.device_time(overlapping)["busy_s"] == pytest.approx(70e-6)


def test_idle_gaps_name_what_the_host_was_doing():
    idle = dict(trace.idle_gaps(_events()))
    # [0, 10): host in the launch at 5; [30, 40): inside bench.submit;
    # [70, 90): after the submission span
    assert idle == pytest.approx({"cudaLaunchKernel": 10e-6,
                                  "bench.submit": 10e-6,
                                  "host: no op recorded": 20e-6})
    # with the device's 60 us inside the window, the gaps fill it
    assert sum(idle.values()) == pytest.approx(40e-6)


@pytest.mark.parametrize("name, frame", [
    (f"{PORT}models/ssm.py(150): mamba2_block", "models/ssm.py:mamba2_block"),
    ("repro_torch/kernels/ssd/ops.py(263): ssd", "kernels/ssd/ops.py:ssd"),
    ("/lib/torch/functional.py(300): einsum", None),
    ("<built-in method einsum of type object at 0x1>", None),
])
def test_port_frame_keeps_the_port_s_frames_only(name, frame):
    assert trace.port_frame(name) == frame


def test_a_large_trace_reduces_in_seconds():
    """Some 200,000 events, a large traced window: every reduction is a
    sweep, not a search per gap."""
    ev = [_x("user_annotation", trace.WINDOW_SPAN, 0, 4e6)]
    for i in range(40_000):
        t = i * 100.0
        ev += [_x("user_annotation", "bench.submit", t, 90),
               _x("python_function", f"{PORT}models/ssm.py(1): f", t + 1,
                  80),
               _x("cpu_op", "aten::mul", t + 2, 10),
               _x("cuda_runtime", "cudaLaunchKernel", t + 3, 2,
                  correlation=i),
               _x("kernel", "k", t + 20, 30, tid=7, correlation=i)]
    t0 = time.perf_counter()
    s = trace.device_time(ev)
    gaps = trace.idle_gaps(ev)
    by = trace.attribute(ev)
    assert time.perf_counter() - t0 < 20
    assert s["busy_s"] == pytest.approx(40_000 * 30e-6)
    assert sum(g for _, g in gaps) == pytest.approx(4.0 - 40_000 * 30e-6)
    assert by == pytest.approx({("models/ssm.py:f",): 40_000 * 30e-6})
