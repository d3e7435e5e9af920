"""whisper-small — enc-dec, conv audio frontend (STUB) [arXiv:2212.04356; unverified].

12L refers to the decoder stack; whisper-small pairs it with a 12-layer
encoder.  input_specs() supplies precomputed 1500-frame embeddings in place
of the conv frontend."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_len=1500,
    act="gelu", frontend="audio",
    source="arXiv:2212.04356; unverified")
