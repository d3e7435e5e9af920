"""Host milliseconds a forward of the device window spent in spans that
wait for the device (tagged ``blocks``: ``im2col.upload``, the index
grids' pageable copies), from the program's spans."""
from repro_torch.obs import trace


def read(r):
    take = getattr(trace, "profiled_forwards", None)
    forwards = take(r.batches) if take is not None else None
    if not forwards:
        return None
    waits = sum(e.dur for _, spans in forwards for e in spans
                if e.tags.get("blocks"))
    return 1e3 * waits / len(forwards)
