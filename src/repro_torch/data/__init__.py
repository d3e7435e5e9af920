"""repro_torch.data — the deterministic synthetic batch stream of the
training path."""

from .pipeline import synthetic_batches, prefetch, make_batch

__all__ = ["synthetic_batches", "prefetch", "make_batch"]
