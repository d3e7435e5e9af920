"""im2col — the lowering of a CONV to a GEMM: the (N·OH·OW, KH·KW·C)
patch matrix written once on the card from NHWC ``x``."""

from .im2col import access_rule, im2col_library, load_im2col
from .ops import im2col_cuda
from .ref import conv_out_shape, im2col_ref

__all__ = ["access_rule", "conv_out_shape", "im2col_cuda", "im2col_library",
           "im2col_ref", "load_im2col"]
