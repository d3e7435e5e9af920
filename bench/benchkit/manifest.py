"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the file that its ``file`` entry gives
(``bench/configs/<name>.json``): the architecture's sizes and nothing of
how it is driven.  A traffic mix is ``bench/traffic/<traffic>.json``,
whose ``loop`` key (``closed`` where it has none) names the generator
that offers it, ``bench/loops/<loop>.py``.  A cell's file
``bench/workloads/<cell>.json`` names its driver ``bench/models/<driver>.py``
(the program's entry point, the work a batch counts, the check) and its
plain reference ``bench/reference/<reference>.py``, and holds its limits
and trace sizes.  An end-to-end metric's statistic is
``bench/end_to_end/<metric>.json`` (a statistic of :mod:`benchkit.stats`)
or ``bench/end_to_end/<metric>.py`` (its own ``value(window, counts)``);
``setup_s`` needs none.  A per-layer metric's reader is
``bench/metrics/<metric>.py``.  A later cell, mix, loop, driver,
configuration or metric is new files and new entries, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

__all__ = ["Bench", "Cell", "load_module"]

DEFAULT_LOOP = "closed"


def load_module(path: Path, prefix: str) -> ModuleType:
    """The module in ``path``, imported under the name
    ``<prefix>_<stem>`` (dots and dashes of the stem made ``_``), once a
    process."""
    name = f"{prefix}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}"
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads``, with the files it names read."""

    name: str
    entry: dict                 # the entry of ``workloads``
    config: dict
    traffic: dict
    workload: dict              # bench/workloads/<name>.json
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def driver(self) -> str:
        return self.workload["driver"]

    @property
    def reference(self) -> str:
        return self.workload["reference"]

    @property
    def loop(self) -> str:
        return self.traffic.get("loop", DEFAULT_LOOP)


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


class Bench:
    """The benchmark rooted at ``root`` (the checkout): ``BENCHMARK.json``
    there, the harness's files under ``root/bench``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "bench"
        self.manifest = json.loads(
            (self.root / "BENCHMARK.json").read_text())

    def _json(self, path: Path) -> dict:
        if not path.is_file():
            raise FileNotFoundError(f"{path} does not exist")
        return json.loads(path.read_text())

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return self._json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> Cell:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return Cell(
                    name=name, entry=w, config=self.config(w["config"]),
                    traffic=self._json(self.dir / "traffic"
                                       / f"{w['traffic']}.json"),
                    workload=self._json(self.dir / "workloads"
                                        / f"{name}.json"),
                    end_to_end=_for_cell(self.manifest["end_to_end"], name),
                    per_layer=_for_cell(self.manifest["per_layer"], name))
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def driver(self, name: str) -> ModuleType:
        """A cell's driver: set-up, the timed entry, the check and the
        counts of work."""
        return load_module(self.dir / "models" / f"{name}.py", "bench_model")

    def reference(self, name: str) -> ModuleType:
        """A cell's plain reference, which its driver's check runs."""
        return load_module(self.dir / "reference" / f"{name}.py",
                           "bench_reference")

    def loop(self, name: str) -> ModuleType:
        """A traffic mix's generator: ``KEYS``, ``check(mix)`` and
        ``make(setup, mix, device)``."""
        return load_module(self.dir / "loops" / f"{name}.py", "bench_loop")

    def statistic(self, metric: str) -> dict | ModuleType:
        """How an end-to-end metric is taken from the window: its
        ``.py`` file's module where there is one, else its ``.json``
        spec."""
        py = self.dir / "end_to_end" / f"{metric}.py"
        if py.is_file():
            return load_module(py, "bench_statistic")
        return self._json(self.dir / "end_to_end" / f"{metric}.json")

    def reader(self, metric: str) -> ModuleType:
        """A per-layer metric's reader: ``read(reading) -> float | None``."""
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "bench_metric")
