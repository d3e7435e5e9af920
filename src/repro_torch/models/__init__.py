"""Models: the paper's CNNs via conv-as-tiled-GEMM."""
