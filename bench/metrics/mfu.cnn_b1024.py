"""The CNN forward's operations (2·m·n·k over its GEMMs, from the layer
shapes) per second of the device window, as a share of the card's float32
peak."""
from benchkit.readers import mfu_pct


def read(r):
    return mfu_pct(r, "float32")
