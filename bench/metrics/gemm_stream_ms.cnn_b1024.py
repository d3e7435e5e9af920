"""Stream milliseconds a forward of the device window between the CUDA
events at the start and end of each ``gemm`` span (idle inside the
stretch included), from the program's spans."""
from repro_torch.obs import trace


def read(r):
    take = getattr(trace, "profiled_forwards", None)
    forwards = take(r.batches) if take is not None else None
    if not forwards:
        return None
    stretches = [e.stream_ms() for _, spans in forwards for e in spans
                 if e.kind == "gemm"]
    if not stretches or None in stretches:
        return None
    return sum(stretches) / len(forwards)
