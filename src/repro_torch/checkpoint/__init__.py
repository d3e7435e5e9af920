"""repro_torch.checkpoint — atomic, async checkpoints of nested tensor
trees (:class:`Checkpointer`), ``repro``'s on-disk layout."""

from .checkpoint import Checkpointer

__all__ = ["Checkpointer"]
