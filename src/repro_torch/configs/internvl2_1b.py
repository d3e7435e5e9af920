"""internvl2-1b — InternViT frontend (STUB) + InternLM2/Qwen2-class LM backbone
[arXiv:2404.16821; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    frontend="vision",                  # input_specs() supplies patch embeddings
    source="arXiv:2404.16821; hf")
