"""Flight recorder: post-mortem dumps without a re-run.

On a serving timeout (``ServeTimeoutError``), an admission rejection
(``AdmissionRejected``), a self-healing quarantine, a panel exhausting
its :class:`~repro_torch.soc.faults.RetryPolicy` (reason ``retry_exhausted``:
the failed panel's jobset, attempt history and the engines it failed
on), or a worker declared dead by the heartbeat monitor (reason
``worker_death``: the dead engine plus its orphaned panel counts), the
recorder snapshots the tracer's last ``last_n`` events plus whatever
``stats()`` views the caller hands it into a timestamped JSON file under
``results/flightrec-*.json``.  Dumps are best-effort (a full disk must
never take down serving) and rate-capped (``max_dumps``) so a
quarantine storm can't fill the results directory.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time


def _jsonable(obj):
    """Best-effort conversion of stats snapshots to JSON-safe values."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "__dataclass_fields__"):
        return {k: _jsonable(getattr(obj, k))
                for k in obj.__dataclass_fields__}
    return repr(obj)


class FlightRecorder:
    """Dump ``(reason, last-N events, stats snapshot)`` to JSON.

    >>> rec = FlightRecorder(tracer, dir="results", last_n=512)
    >>> rec.dump("serve_timeout", stats=rt.stats(), context={"rid": 3})
    'results/flightrec-20260808-120000-0-serve_timeout.json'
    """

    def __init__(self, tracer=None, *, dir: str = "results",
                 last_n: int = 512, max_dumps: int = 16,
                 prefix: str = "flightrec"):
        self.tracer = tracer
        self.dir = dir
        self.last_n = int(last_n)
        self.max_dumps = int(max_dumps)
        self.prefix = prefix
        self.dumps: list[str] = []      # paths written, oldest first
        self.suppressed = 0             # dumps skipped past the cap
        self._lock = threading.Lock()
        self._seq = itertools.count()

    def dump(self, reason: str, *, stats=None, context=None) -> str | None:
        """Write one dump; returns the path or ``None`` (capped/failed).
        Never raises — the recorder must not add failure modes to the
        paths it observes."""
        with self._lock:
            if len(self.dumps) >= self.max_dumps:
                self.suppressed += 1
                return None
            seq = next(self._seq)
        try:
            events = self.tracer.events() if self.tracer is not None else []
            payload = {
                "reason": reason,
                "stamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                           time.gmtime()),
                "context": _jsonable(context or {}),
                "stats": _jsonable(stats or {}),
                "n_events": min(len(events), self.last_n),
                "dropped_events": (self.tracer.dropped
                                   if self.tracer is not None else 0),
                "events": [e.to_dict() for e in events[-self.last_n:]],
            }
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in reason)[:40]
            stamp = time.strftime("%Y%m%d-%H%M%S")
            path = os.path.join(
                self.dir, f"{self.prefix}-{stamp}-{seq}-{safe}.json")
            os.makedirs(self.dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f)
        except OSError:
            return None
        with self._lock:
            self.dumps.append(path)
        return path
