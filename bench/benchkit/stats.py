"""The end-to-end statistics that a metric's ``bench/end_to_end/<metric>.json``
names.  A metric whose statistic is none of these brings its own
``bench/end_to_end/<metric>.py`` with ``value(window, counts)``.

- ``{"stat": "rate", "count": <key>}``: what the window's records count
  under that key (each record's own counts, else the driver's counts of a
  batch), over the window's seconds;
- ``{"stat": "percentile", "q": 95, "of": "latency", "scale": 1000}``:
  the q-th percentile over all the window's records of the time from
  submission until the answers reached the host, times ``scale``.
"""

from __future__ import annotations

import statistics

__all__ = ["total", "value"]


def total(window, counts: dict, key: str) -> float:
    """What the window's records count under ``key``."""
    return float(sum((b.counts or counts)[key] for b in window.batches))


def value(spec: dict, window, counts: dict) -> float:
    if spec["stat"] == "rate":
        return total(window, counts, spec["count"]) / window.seconds
    if spec["stat"] == "percentile" and spec["of"] == "latency":
        lat = [b.done - b.submitted for b in window.batches]
        cut = (statistics.quantiles(lat, n=100, method="inclusive")
               [int(spec["q"]) - 1] if len(lat) > 1 else lat[0])
        return cut * spec.get("scale", 1.0)
    raise ValueError(f"unknown statistic {spec!r}")
