from .ops import tiled_matmul
from .ref import ffma_chain_ref, tiled_mm_ref
from .tiled_mm import PATHS, load_tiled_mm, tiled_mm_library
