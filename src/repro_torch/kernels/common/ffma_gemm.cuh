// The register-blocked FFMA GEMM mainloop that tiled_mm.cu's fp32 path
// (K1) and vpu_mm.cu (K3) share: C = act(A @ B + bias) on the CUDA cores.
//
// A block owns a BM x BN output tile and walks k in steps of BK staged
// through a ring of STAGES shared-memory buffers, so STAGES - 1 steps load
// while one multiplies.  fp32 is staged by 4-byte cp.async (A transposed
// element by element into a k-major buffer, so that a thread's rows are one
// vector read); bf16 (K3 only) is staged as bf16 by plain 2-byte loads,
// which cp.async cannot move, and widened to fp32 when read into
// registers.  What lies outside (m, k) or (k, n) is staged as zeros, which
// add nothing to the sums; nothing is padded in device memory.
//
// Every output starts from 0.0f and takes one fmaf per k in increasing k in
// one accumulator, whatever the tile, the ring or the input type, and the
// epilogue is epilogue_store (common/epilogue.cuh).  So an output's bits
// depend only on its row of A, on B and on k: each kernel may choose its
// tile by shape, and a row panel gives the whole GEMM's bits in either
// kernel.  Each kernel keeps its own __global__ function (the profiler
// books time by its name) and calls gemm() below.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "launch.cuh"
#include "ptx.cuh"

namespace synergy {
namespace ffma {

// A BM x BN block tile, k steps of BK through STAGES buffers; thread
// (ty, tx) owns an RM x RN grid of V x V quads: rows q (BM / RM) + V ty + i
// and cols q' (BN / RN) + V tx + j (i, j < V), so neighbouring threads read
// neighbouring vectors and the shared-memory reads meet no bank conflict.
template <int BM_, int BN_, int RM_, int RN_, int V_ = 4, int BK_ = 16,
          int STAGES_ = 4>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, RM = RM_, RN = RN_, V = V_;
  static constexpr int BK = BK_, STAGES = STAGES_;
  static constexpr int TM = V * RM, TN = V * RN;
  static constexpr int TX = BN / TN;
  static constexpr int THREADS = (BM / TM) * TX;
  static constexpr int ALD = BM + 4;        // keeps vector alignment
  static constexpr int A_ELEMS = BK * ALD;
  static constexpr int B_ELEMS = BK * BN;
  template <typename TIn>
  static constexpr size_t smem() {
    return sizeof(TIn) * STAGES * (size_t)(A_ELEMS + B_ELEMS);
  }
};

// K1's fp32 tiles (tiled_mm.cu chooses among them; K3 takes the first two
// for GEMMs that fill the card)
using Wide = Tile<128, 128, 2, 2>;   // 256 threads, 8 x 8 each
using Narrow = Tile<128, 64, 2, 2>;  // 128 threads, 8 x 8 each
using Small = Tile<32, 64, 1, 1>;    // 128 threads, 4 x 4 each

// One element global -> shared, zero when !in (src must still be a valid
// address): a 4-byte cp.async for fp32, a plain load and store for bf16.
__device__ __forceinline__ void stage_elem(float* dst, const float* src,
                                           bool in) {
  cp_async4(dst, src, in ? 4 : 0);
}
__device__ __forceinline__ void stage_elem(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool in) {
  *dst = in ? *src : __float2bfloat16(0.0f);
}

// V neighbouring elements of shared memory as fp32, in one vector read
template <int V>
__device__ __forceinline__ void read_vec(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void read_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (V == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[0] = lo.x, out[1] = lo.y, out[2] = hi.x, out[3] = hi.y;
  } else if constexpr (V == 2) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

// The block's tile of act(A @ B + bias): blockIdx.x walks m, blockIdx.y n;
// smem holds T::smem<TIn>() bytes (A is stored k-major).
template <typename T, typename TIn, typename TOut, int ACT>
__device__ __forceinline__ void gemm(const TIn* __restrict__ a,
                                     const TIn* __restrict__ b,
                                     const float* __restrict__ bias,
                                     TOut* __restrict__ c, int m, int n,
                                     int k, TIn* smem) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, STAGES = T::STAGES;
  constexpr int TM = T::TM, TN = T::TN, V = T::V, THREADS = T::THREADS;
  TIn* As = smem;                          // STAGES x BK x ALD
  TIn* Bs = smem + STAGES * T::A_ELEMS;    // STAGES x BK x BN

  const int tid = threadIdx.x;
  const int tx = tid % T::TX;
  const int ty = tid / T::TX;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int steps = (k + BK - 1) / BK;

  // k step `st` into its buffer (nothing past the last step: an empty
  // group keeps the count of groups in flight)
  auto stage = [&](int st) {
    if (st < steps) {
      const int k0 = st * BK;
      TIn* as = As + (st % STAGES) * T::A_ELEMS;
      TIn* bs = Bs + (st % STAGES) * T::B_ELEMS;
#pragma unroll
      for (int l = 0; l < BM * BK / THREADS; ++l) {
        const int idx = tid + l * THREADS;
        const int r = idx / BK, kk = idx % BK;
        const bool in = row0 + r < m && k0 + kk < k;
        stage_elem(&as[kk * T::ALD + r], in ? a + (row0 + r) * k + k0 + kk : a,
                   in);
      }
#pragma unroll
      for (int l = 0; l < BK * BN / THREADS; ++l) {
        const int idx = tid + l * THREADS;
        const int kk = idx / BN, cc = idx % BN;
        const bool in = k0 + kk < k && col0 + cc < n;
        stage_elem(&bs[kk * BN + cc],
                   in ? b + (int64_t)(k0 + kk) * n + col0 + cc : b, in);
      }
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) stage(st);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();    // step st has landed
    __syncthreads();                // and step st - 1's buffer is free
    stage(st + STAGES - 1);
    const TIn* as = As + (st % STAGES) * T::A_ELEMS;
    const TIn* bs = Bs + (st % STAGES) * T::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[TM], br[TN];
#pragma unroll
      for (int q = 0; q < T::RM; ++q)
        read_vec<V>(&as[kk * T::ALD + q * (BM / T::RM) + V * ty], &ar[V * q]);
#pragma unroll
      for (int q = 0; q < T::RN; ++q)
        read_vec<V>(&bs[kk * BN + q * (BN / T::RN) + V * tx], &br[V * q]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gc = col0 + (j / V) * (BN / T::RN) + V * tx + j % V;
    if (gc >= n) continue;
    const float bj = bias_at(bias, gc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gr = row0 + (i / V) * (BM / T::RM) + V * ty + i % V;
      if (gr < m) epilogue_store<ACT>(&c[gr * n + gc], acc[i][j], bj);
    }
  }
}

// Whether 128-row tiles (Wide, or Narrow for n <= 64) would reach half the
// SMs; below that, a kernel takes a tile with fewer rows.
inline bool big_tiles_fill_card(int m, int n) {
  const int bn = n <= 64 ? Narrow::BN : Wide::BN;
  const int64_t blocks = (int64_t)((m + 127) / 128) * ((n + bn - 1) / bn);
  return 2 * blocks >= sm_count();
}

// Launch `kernel` (a __global__ wrapper of gemm<T, TIn, TOut, ACT>) with
// T's grid, block and shared memory on stream s.
template <typename T, typename TIn, typename TOut, typename Kernel>
int launch_tile(Kernel kernel, const TIn* a, const TIn* b, const float* bias,
                TOut* c, int m, int n, int k, cudaStream_t s) {
  constexpr size_t smem = T::template smem<TIn>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + T::BM - 1) / T::BM, (n + T::BN - 1) / T::BN);
  kernel<<<grid, T::THREADS, smem, s>>>(a, b, bias, c, m, n, k);
  return (int)cudaSuccess;
}

}  // namespace ffma
}  // namespace synergy
