"""zamba2-2.7b — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=6,                      # one shared attn+MLP block per 6 mamba blocks
    act="gelu",
    source="arXiv:2411.15242; hf (hybrid: Mamba2 + shared attn blocks)")
