"""Architecture registry: the 10 assigned archs + the paper's 7 CNNs."""

from .base import ArchConfig, ShapeCell, SHAPES, reduced, torch_dtype
from .zamba2_2p7b import CONFIG as ZAMBA2_2P7B
from .dbrx_132b import CONFIG as DBRX_132B
from .kimi_k2_1t import CONFIG as KIMI_K2_1T
from .internvl2_1b import CONFIG as INTERNVL2_1B
from .internlm2_20b import CONFIG as INTERNLM2_20B
from .granite_3_2b import CONFIG as GRANITE_3_2B
from .phi3_medium_14b import CONFIG as PHI3_MEDIUM_14B
from .gemma_7b import CONFIG as GEMMA_7B
from .mamba2_130m import CONFIG as MAMBA2_130M
from .whisper_small import CONFIG as WHISPER_SMALL
from .paper_cnns import PAPER_CNNS

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (
    ZAMBA2_2P7B, DBRX_132B, KIMI_K2_1T, INTERNVL2_1B, INTERNLM2_20B,
    GRANITE_3_2B, PHI3_MEDIUM_14B, GEMMA_7B, MAMBA2_130M, WHISPER_SMALL,
)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
