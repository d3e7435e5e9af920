"""Process-wide engine registry + per-op variant registry.

Two registries back the unified dispatch surface:

  * **Engine registry** — named :class:`~repro_torch.engines.base.Engine` objects
    (GEMM backends + simulated paper PEs).  ``register_engine`` is the ONE
    call needed to bring a new backend online: the dispatcher, the
    schedulers and every ``synergy_matmul`` call site pick it up with zero
    edits.
  * **Op-variant registry** — named implementations of non-GEMM kernels
    (flash attention, SSD scan, attention scores).  ``resolve_op`` replaces
    the old string-compare ``impl`` branching: variants carry a priority
    and an availability predicate, and ``"auto"`` resolves to the
    highest-priority variant available on the current backend.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Iterator, Optional

from .base import Engine

__all__ = [
    "register_engine", "unregister_engine", "get_engine", "find_engine",
    "list_engines", "registered",
    "add_registry_listener", "remove_registry_listener",
    "OpVariant", "register_op_impl", "resolve_op", "op_variants",
]

_LOCK = threading.RLock()
_ENGINES: dict[str, Engine] = {}
_LISTENERS: list[Callable[[str, Engine], None]] = []


# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------

def add_registry_listener(fn: Callable[[str, Engine], None]) -> Callable:
    """Subscribe ``fn(event, engine)`` to registry changes; ``event`` is
    ``"register"`` or ``"unregister"``.  The live SynergyRuntime uses this
    to rebalance its worker pool when engines come and go mid-run."""
    with _LOCK:
        _LISTENERS.append(fn)
    return fn


def remove_registry_listener(fn: Callable[[str, Engine], None]) -> None:
    with _LOCK:
        if fn in _LISTENERS:
            _LISTENERS.remove(fn)


def _notify(event: str, engine: Engine) -> None:
    # outside _LOCK: listeners (runtime rebalance) take their own locks and
    # may read the registry
    with _LOCK:
        listeners = list(_LISTENERS)
    for fn in listeners:
        fn(event, engine)


def register_engine(engine: Engine, *, override: bool = False) -> Engine:
    """Register ``engine`` under ``engine.name``; returns it for chaining."""
    with _LOCK:
        if engine.name in _ENGINES and not override:
            raise ValueError(
                f"engine {engine.name!r} already registered "
                f"({_ENGINES[engine.name]!r}); pass override=True to replace")
        _ENGINES[engine.name] = engine
    _notify("register", engine)
    return engine


def unregister_engine(name: str) -> Optional[Engine]:
    with _LOCK:
        engine = _ENGINES.pop(name, None)
    if engine is not None:
        _notify("unregister", engine)
    return engine


def get_engine(name: str) -> Engine:
    with _LOCK:
        try:
            return _ENGINES[name]
        except KeyError:
            known = sorted(_ENGINES)
            raise KeyError(f"no engine {name!r}; registered: {known}") from None


def find_engine(name: str) -> Optional[Engine]:
    with _LOCK:
        return _ENGINES.get(name)


def list_engines() -> list[Engine]:
    with _LOCK:
        return list(_ENGINES.values())


@contextlib.contextmanager
def registered(*engines: Engine) -> Iterator[tuple[Engine, ...]]:
    """Temporarily register engines (tests / scoped experiments), restoring
    any same-named engines they shadowed on exit."""
    shadowed: dict[str, Optional[Engine]] = {}
    with _LOCK:
        for e in engines:
            shadowed[e.name] = _ENGINES.get(e.name)
            _ENGINES[e.name] = e
    for e in engines:
        _notify("register", e)
    try:
        yield engines
    finally:
        with _LOCK:
            for name, prev in shadowed.items():
                if prev is None:
                    _ENGINES.pop(name, None)
                else:
                    _ENGINES[name] = prev
        for e in engines:
            prev = shadowed[e.name]
            if prev is None:
                _notify("unregister", e)
            else:
                _notify("register", prev)


# ---------------------------------------------------------------------------
# Op-variant registry (non-GEMM kernels)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpVariant:
    """One named implementation of an op family.

    ``priority`` ranks variants for ``"auto"`` resolution (higher wins);
    ``available`` gates auto-selection (an explicitly named variant always
    resolves — e.g. a kernel's plain version on the CPU)."""

    op: str
    name: str
    fn: Callable
    priority: int = 0
    available: Callable[[], bool] = lambda: True


_OPS: dict[str, dict[str, OpVariant]] = {}


def register_op_impl(op: str, name: str, fn: Callable, *, priority: int = 0,
                     available: Callable[[], bool] | None = None,
                     override: bool = False) -> OpVariant:
    variant = OpVariant(op, name, fn, priority,
                        available if available is not None else (lambda: True))
    with _LOCK:
        table = _OPS.setdefault(op, {})
        if name in table and not override:
            raise ValueError(f"variant {name!r} of op {op!r} already "
                             f"registered; pass override=True to replace")
        table[name] = variant
    return variant


def op_variants(op: str) -> list[OpVariant]:
    with _LOCK:
        return sorted(_OPS.get(op, {}).values(), key=lambda v: -v.priority)


def resolve_op(op: str, name: str = "auto") -> Callable:
    """Resolve an op implementation.  ``"auto"`` picks the highest-priority
    variant whose ``available()`` is true; an explicit name always resolves
    (KeyError if unknown)."""
    with _LOCK:
        table = _OPS.get(op)
        if not table:
            raise KeyError(f"no variants registered for op {op!r}")
        if name != "auto":
            try:
                return table[name].fn
            except KeyError:
                raise KeyError(f"op {op!r} has no variant {name!r}; "
                               f"known: {sorted(table)}") from None
        ranked = sorted(table.values(), key=lambda v: (-v.priority, v.name))
    for v in ranked:
        if v.available():
            return v.fn
    raise RuntimeError(f"no available variant for op {op!r} on this backend")
