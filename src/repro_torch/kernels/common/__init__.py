"""What the port's GEMM kernels share: the nvcc build and ctypes binding
(:mod:`.build`), the checked launch with its locked launch counts
(:mod:`.gemm`), and the device-side epilogue (``epilogue.cuh``)."""
