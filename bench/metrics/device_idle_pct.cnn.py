"""The share of the device window in which no kernel, copy or set ran on
the card."""
from benchkit.readers import idle_pct


def read(r):
    return idle_pct(r)
