"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8,
    param_dtype="bfloat16", optimizer="adafactor", fsdp=True,
    source="arXiv:2501.kimi2 paper-table; unverified")
