"""Device milliseconds a batch of everything launched from
``repro_torch/core/im2col.py`` (the lowering of each CONV to a GEMM)."""
from benchkit.readers import device_s_per_batch


def read(r):
    s = device_s_per_batch(r, ("core/im2col.py",))
    return None if s is None else 1e3 * s
