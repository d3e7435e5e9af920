"""internlm2-20b — dense GQA transformer [arXiv:2403.17297; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92544,
    fsdp=True,
    source="arXiv:2403.17297; hf")
