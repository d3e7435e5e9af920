from .ops import tiled_matmul
from .ref import tiled_mm_ref
from .tiled_mm import load_tiled_mm
