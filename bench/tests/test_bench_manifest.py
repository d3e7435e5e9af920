"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names present."""

import json
import re

import pytest

import bench_testkit as tk

M = tk.manifest()
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = {w["name"]: w for w in M["workloads"]}
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _reports(cell, metric):
    return cell in metric.get("workloads", [cell])


def test_top_level_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((tk.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (tk.ROOT / p).is_dir()
    assert 1 <= len(M["command"]) <= 32
    assert all(_one_line(w) for w in M["command"])
    files = [w for w in M["command"] if "/" in w]
    assert files and all(any(f.startswith(p + "/") for p in M["paths"])
                         for f in files)
    assert all((tk.ROOT / f).is_file() for f in files)


def test_run_seconds_fits_a_full_check_of_24_cells():
    r = M["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(M["workloads"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _one_line(m["layer"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_each_configuration_file_exists_and_is_used(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(cfg["name"]) and _one_line(cfg["source"])
    assert cfg["file"].startswith("bench/configs/")
    body = json.loads((tk.ROOT / cfg["file"]).read_text())
    assert body["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16
    assert any(w["config"] == cfg["name"] for w in M["workloads"])
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_has_its_files_and_reports_what_it_must(cell):
    w = CELLS[cell]
    assert w["config"] in {c["name"] for c in M["configs"]}
    assert (tk.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    mix = json.loads((tk.BENCH / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    assert (tk.BENCH / "loops" / f"{mix.get('loop', 'closed')}.py").is_file()
    spec = json.loads((tk.BENCH / "workloads" / f"{cell}.json").read_text())
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    assert (tk.BENCH / "models" / f"{spec['driver']}.py").is_file()
    assert (tk.BENCH / "reference" / f"{spec['reference']}.py").is_file()
    assert set(spec["trace"]) == {"device_batches", "gap_batches",
                                  "layer_batches"}
    e2e = [m for m in M["end_to_end"] if _reports(cell, m)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    for m in e2e:
        if m["name"] != "setup_s":
            assert any((tk.BENCH / "end_to_end" / f"{m['name']}{ext}")
                       .is_file() for ext in (".json", ".py"))
    assert any(_reports(cell, m) for m in M["per_layer"])


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_a_metric_its_cells_report(metric):
    moved = E2E[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert _reports(cell, moved)
    assert (tk.BENCH / "metrics" / f"{metric['name']}.py").is_file()


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    folded = {re.sub(r"\s+", " ", x.strip().lower()) for x in layers}
    assert len(folded) == len(layers)
