// Shared by the port's GEMM kernels (tiled_mm.cu, vpu_mm.cu, qmm.cu): what
// a launch asks of the card before it picks a tile.

#pragma once

#include <cuda_runtime.h>

namespace synergy {

// The card's SM count, asked once per process: the GEMM kernels choose a
// tile by whether its grid would fill the card.
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return sms;
}

}  // namespace synergy
