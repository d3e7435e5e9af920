"""The check of a traffic mix (``bench/traffic/<name>.json``), a file of
parameters.

A mix's keys are read by the loop that offers it (``bench/loops/<loop>.py``,
named by its ``loop`` key, ``closed`` where it has none; its ``KEYS``)
and by the cell's driver (its ``TRAFFIC_KEYS``: sizes it draws, such as a
prompt's length), besides:

- ``loop``: the loop's name;
- ``entry``: keyword arguments of the program's entry point (such as a
  ``job_class``), passed as they are;
- ``why``: one line on what the mix stands for.

A key that neither reads is refused, so that a mix never says more than
is run.
"""

from __future__ import annotations

from types import ModuleType

__all__ = ["COMMON_KEYS", "check_mix"]

COMMON_KEYS = {"loop", "entry", "why"}


def check_mix(mix: dict, loop: ModuleType, driver: ModuleType) -> dict:
    """The mix, after a check of its keys and, by its loop, its sizes."""
    known = COMMON_KEYS | set(loop.KEYS) | set(
        getattr(driver, "TRAFFIC_KEYS", ()))
    unknown = set(mix) - known
    if unknown:
        raise ValueError(f"traffic mix: unknown keys {sorted(unknown)}")
    loop.check(mix)
    return mix
