"""ArchConfig: the declarative architecture description (the Synergy
"network configuration file" of Fig 1/8, adapted to LM families), plus the
assigned input-shape set."""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "reduced", "torch_dtype"]

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config names ('float32', 'bfloat16', 'int8')."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    act: str = "silu"            # 'silu' (SwiGLU) | 'gelu' (GeGLU)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # hybrid (zamba2): one SHARED attention+MLP block applied every k layers
    attn_every: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_len: int = 1500      # whisper 30 s @ 50 Hz after conv frontend
    # modality frontend stub: 'none' | 'audio' | 'vision'
    frontend: str = "none"
    # numerics / memory policy (per-arch defaults; launch can override)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = ""        # KV-cache storage ('' -> compute dtype;
                                 # 'int8' for quantized decode, §Perf B2)
    optimizer: str = "adamw"     # 'adamw' | 'adafactor' (giant archs)
    fsdp: bool = False           # shard params/opt over the data axis
    remat: bool = True
    source: str = ""             # provenance note

    # ---- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM/hybrid only — §DESIGN)"""
        return self.family in ("ssm", "hybrid")

    @property
    def takes_embeddings(self) -> bool:
        """Modality-frontend archs consume precomputed embeddings (stub)."""
        return self.frontend != "none"

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def n_params(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        mlp_dense = 3 * d * self.d_ff
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "moe":
            mlp = self.n_experts * mlp_dense + d * self.n_experts  # + router
            per_layer = attn + mlp
            n = self.n_layers * per_layer
        elif self.family == "ssm":
            per_layer = self._ssm_block_params()
            n = self.n_layers * per_layer
        elif self.family == "hybrid":
            n_groups = self.n_layers // max(1, self.attn_every)
            shared = attn + mlp_dense
            n = self.n_layers * self._ssm_block_params() + shared
        elif self.family == "audio":
            dec = self.n_layers * (attn * 2 + mlp_dense)  # self+cross attn
            enc = self.encoder_layers * (attn + mlp_dense)
            n = dec + enc
        else:
            n = self.n_layers * (attn + mlp_dense)
        return n + emb + self.n_layers * 2 * d  # + norms

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        mlp_active = 3 * d * self.d_ff * self.top_k + d * self.n_experts
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + mlp_active + 2 * d) + emb

    def _ssm_block_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * n + h)
        return in_proj + di * d + h + di  # + out_proj + A + D


# ---------------------------------------------------------------------------
# Input-shape cells (assigned set; identical across the 10 archs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 64,
            n_heads: int = 4, d_ff: int = 128, vocab: int = 512,
            n_experts: int | None = None) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kv = max(1, min(cfg.n_kv_heads, n_heads) if cfg.n_kv_heads else n_heads)
    while n_heads % kv:
        kv -= 1
    ne = n_experts if n_experts is not None else (4 if cfg.n_experts else 0)
    attn_every = 2 if cfg.attn_every else 0
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=kv, d_ff=d_ff, vocab_size=vocab, head_dim=0,
        n_experts=ne, top_k=min(cfg.top_k, ne) if ne else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64, ssm_chunk=16,
        attn_every=attn_every,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_len=24 if cfg.encoder_layers else 1500,
        param_dtype="float32", compute_dtype="float32", fsdp=False)
