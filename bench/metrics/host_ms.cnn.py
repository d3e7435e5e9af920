"""Median host milliseconds of one forward in the device window: the
program's ``cnn.forward`` span, the host's time to issue one batch."""
import statistics

from repro_torch.obs import trace


def read(r):
    take = getattr(trace, "profiled_forwards", None)
    forwards = take(r.batches) if take is not None else None
    if not forwards:
        return None
    return 1e3 * statistics.median(f.dur for f, _ in forwards)
