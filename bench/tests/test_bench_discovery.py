"""Configurations, traffic mixes, cells, loops, drivers and metrics added
as new files and new entries of ``BENCHMARK.json`` alone, with no file of
the harness edited, are found and run."""

import json

import pytest

import bench_testkit as tk
from benchkit.manifest import Bench
from benchkit.readers import Reading


def _files(root):
    return {p: p.read_bytes() for p in (root / "bench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _write(path, body):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(body if isinstance(body, str) else json.dumps(body))


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = tk.small_checkout(tmp_path)
    before = _files(root)
    b = root / "bench"
    # the paper's CIFAR_Alex (Synergy, Table 2), its own file
    _write(b / "configs/cifar_alex.json", {
        "name": "CIFAR_Alex", "source": "arXiv:1804.00706",
        "input_hw": 32, "cin": 3, "num_classes": 10, "tile": 32,
        "dtype": "float32", "reduced": [],
        "layers": [["conv", 32, 5, 1, 2], ["pool", 2],
                   ["conv", 32, 5, 1, 2], ["pool", 2],
                   ["conv", 64, 5, 1, 2], ["pool", 2],
                   ["fc", 64], ["fc", 10]]})
    _write(b / "traffic/b8_in_flight3.json",
           {"batch": 8, "pool": 3, "in_flight": 3, "warmup_batches": 1})
    _write(b / "workloads/alex.b8_in_flight3.json",
           {"driver": "cnn", "reference": "cnn",
            "limits": {"logits_err": 2e-5},
            "trace": {"device_batches": 4, "gap_batches": 2,
                      "layer_batches": 2}})
    _write(b / "metrics/batches_traced.alex.py",
           "def read(r):\n    return float(r.batches)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "cifar_alex", "source": "arXiv:1804.00706",
                         "file": "bench/configs/cifar_alex.json",
                         "reduced": [], "why": "a second paper network"})
    m["workloads"].append({"name": "alex.b8_in_flight3",
                           "config": "cifar_alex",
                           "traffic": "b8_in_flight3", "chips": 1,
                           "why": "three in flight"})
    for e in m["end_to_end"]:
        if e["name"] in ("frames_per_s", "batch_p95_ms"):
            e["workloads"].append("alex.b8_in_flight3")
    m["per_layer"].append({"name": "batches_traced.alex", "unit": "batches",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "frames_per_s",
                           "workloads": ["alex.b8_in_flight3"]})
    _write(root / "BENCHMARK.json", m)

    bench = Bench(root)
    cell = bench.cell("alex.b8_in_flight3")
    assert cell.config["name"] == "CIFAR_Alex"
    assert [x["name"] for x in cell.per_layer] == ["batches_traced.alex"]
    r = tk.run_small(root, "alex.b8_in_flight3")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"frames_per_s", "batch_p95_ms", "setup_s"}
    reading = Reading(config=cell.config, traffic=cell.traffic,
                      driver=bench.driver("cnn"), window_s=1.0, busy_s=0.5,
                      batches=7, layer_batches=2, by_stack={})
    assert bench.reader("batches_traced.alex").read(reading) == 7.0
    assert bench.reader("mfu.cnn").read(reading) > 0
    # the old cell is untouched and every file that was there is as it was
    assert {p: p.read_bytes() for p in before} == before
    assert bench.cell("alexplus.fp32_b256").traffic["batch"] == 4


# A second entry point of the program: one GEMM through
# ``synergy_matmul``, driven by a loop of its own that offers requests at
# a fixed interval and counts each by its own size, with a traffic key
# that only the new driver reads and an end-to-end statistic that is code.
_DRIVER = '''
import torch

from benchkit.cell import Setup

TRAFFIC_KEYS = {"m", "n", "k"}


def setup(config, traffic, seed, device, reference):
    from repro_torch.core.synergy_mm import synergy_matmul
    g = torch.Generator(device=device).manual_seed(seed)
    m, n, k = traffic["m"], traffic["n"], traffic["k"]
    a = torch.randn((traffic["pool"], m, k), generator=g, device=device)
    b = torch.randn((k, n), generator=g, device=device)

    def check(done):
        worst = 0.0
        for d in done:
            ref = reference.product(a[d.index], b)
            worst = max(worst, ((d.output - ref).abs().amax()
                                / ref.abs().amax()).item())
        return {"product_err": worst}

    return Setup(entry=lambda i: synergy_matmul(a[i], b, tile=config["tile"]),
                 answer=lambda out: out.sum(dim=-1),
                 counts={"requests": 1, "flops": 2 * m * n * k},
                 check=check, control=None)
'''

_REFERENCE = '''
import torch


def product(a, b):
    return a.double() @ b.double()
'''

_LOOP = '''
import itertools
import time

from benchkit.loop import Done, Window

KEYS = {"pool", "interval_ms", "warmup_requests"}


def check(mix):
    assert mix["interval_ms"] > 0


class Paced:
    def __init__(self, setup, mix, device):
        self.setup, self.mix = setup, mix
        self.order = itertools.cycle(range(mix["pool"]))

    def warmup(self):
        self.window(count=self.mix["warmup_requests"])

    def window(self, seconds=None, count=None, span=None):
        start, done = time.perf_counter(), []
        step = self.mix["interval_ms"] / 1e3
        for n in itertools.count():
            arrival = start + n * step
            if (count is not None and n >= count) or (
                    seconds is not None and arrival - start >= seconds):
                break
            time.sleep(max(0.0, arrival - time.perf_counter()))
            i = next(self.order)
            out = self.setup.entry(i)
            host = self.setup.answer(out).clone()
            done.append(Done(i, out, host, arrival, time.perf_counter(),
                             counts={**self.setup.counts, "requests": 1}))
        return Window(done, start, done[-1].done)


def make(setup, mix, device):
    return Paced(setup, mix, device)
'''

_STATISTIC = '''
def value(window, counts):
    return sum(b.counts["flops"] for b in window.batches) \\
        / window.seconds / 1e12
'''


def test_a_cell_on_a_second_entry_point_is_new_files_only(tmp_path):
    root = tk.small_checkout(tmp_path)
    before = _files(root)
    b = root / "bench"
    _write(b / "models/gemm.py", _DRIVER)
    _write(b / "reference/gemm.py", _REFERENCE)
    _write(b / "loops/paced.py", _LOOP)
    _write(b / "end_to_end/gemm_tflops.py", _STATISTIC)
    _write(b / "configs/gemm_tile32.json", {"tile": 32, "reduced": []})
    _write(b / "traffic/paced_64.json",
           {"loop": "paced", "pool": 2, "interval_ms": 5,
            "warmup_requests": 1, "m": 64, "n": 48, "k": 40})
    _write(b / "workloads/gemm.paced_64.json",
           {"driver": "gemm", "reference": "gemm",
            "limits": {"product_err": 1e-5},
            "trace": {"device_batches": 4, "gap_batches": 2,
                      "layer_batches": 2}})
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "gemm_tile32", "source": "arXiv:1804.00706",
                         "file": "bench/configs/gemm_tile32.json",
                         "reduced": [], "why": "one tile-job GEMM"})
    m["workloads"].append({"name": "gemm.paced_64", "config": "gemm_tile32",
                           "traffic": "paced_64", "chips": 1,
                           "why": "one GEMM a request, every 5 ms"})
    m["end_to_end"].append({"name": "gemm_tflops", "unit": "TFLOP/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["gemm.paced_64"]})
    _write(root / "BENCHMARK.json", m)

    r = tk.run_small(root, "gemm.paced_64")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"gemm_tflops", "setup_s"}
    assert r["metrics"]["gemm_tflops"]["value"] > 0
    # the window is 0.05 s of requests every 5 ms: each counted once
    assert 5 <= r["attempted"] <= 11
    assert {p: p.read_bytes() for p in before} == before


def test_a_mix_key_that_neither_its_loop_nor_its_driver_reads_is_refused(
        tmp_path):
    root = tk.small_checkout(tmp_path)
    path = root / "bench/traffic/fp32_b256.json"
    mix = json.loads(path.read_text())
    _write(path, {**mix, "prompt_len": 64})
    with pytest.raises(ValueError, match="prompt_len"):
        tk.run_small(root, "alexplus.fp32_b256")


def test_a_run_that_built_kernels_says_so(tmp_path):
    """The first run in a checkout builds the program's kernels: its
    result names them under ``setup``, so that its set-up is recorded
    apart; a run that finds them built says it built none."""
    from benchkit import runner
    root = tk.small_checkout(tmp_path)
    lib = root / "build" / "kernels"

    def build_at_setup(setup):
        lib.mkdir(parents=True, exist_ok=True)
        (lib / "tiled_mm-0123.so").write_bytes(b"")
    first = tk.run_small(root, "alexplus.fp32_b256", setup_hook=build_at_setup)
    assert first["setup"] == {"compiling_run": True,
                              "built": ["tiled_mm-0123.so"]}
    again = tk.run_small(root, "alexplus.fp32_b256")
    assert again["setup"] == {"compiling_run": False, "built": []}
    assert list(again)[-1] == "checks"
    assert runner.built_kernels(root) == {"tiled_mm-0123.so"}
