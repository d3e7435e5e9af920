// vpu_mm: C[m, n] = act(A[m, k] @ B[k, n] + bias[n]) for Hopper (sm_90a),
// on the CUDA cores only, as increasing-k rank-1 updates.
//
// Replaces the TPU kernel src/repro/kernels/vpu_mm/vpu_mm.py::vpu_mm_pallas,
// the MXU-free matmul that stands for the paper's NEON SIMD cores: the
// pool's slow, always-available engine.  Like the Pallas kernel it never
// touches the matrix unit: no mma, wgmma or other tensor-core instruction,
// only FFMA (chip_smoke.py checks the SASS for HMMA/GMMA/IMMA).
//
// What bounds it on an H100: the fp32 FMA rate of the CUDA cores (67
// TFLOP/s dense on the SXM part) for the wide-k GEMMs, device-memory bytes
// (3.35 TB/s) for thin k.  It is deliberately simple and reaches neither:
// each 64-thread block owns a 32-row x 64-column output tile (32 rows is
// the runtime's row panel, the paper's TS), one thread per column holding
// that column's 32 sums in registers.  A 32 x 32 slice of A is staged
// through shared memory k-major, so a column of A is one contiguous row
// that every thread reads as a broadcast; each step of k is the rank-1
// update  acc[0:32] += A[0:32, kk] * B[kk, col]  — the Pallas kernel's
// `acc + a_col * b_row`, one lane per column.  There is no register
// micro-tiling of B and no software pipelining: one B load and eight
// shared loads feed 32 FMAs.
//
// Determinism: every output starts from 0.0f and takes one fmaf per k in
// increasing k, and the epilogue is the shared device function of
// common/epilogue.cuh, exactly as in tiled_mm.cu.  So an output's bits do
// not depend on the block it lies in, on the row panel it was computed in,
// or on which of the two kernels computed it.  Ragged edges are masked in
// the loads, the k loop and the stores; nothing is padded.
//
// Interface: plain C, bound with ctypes, the same as tiled_mm's.  The
// launch goes on the caller's stream, allocates nothing and does not
// synchronise; the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

using namespace synergy;

constexpr int BM = 32;   // block tile rows: one runtime row panel
constexpr int BN = 64;   // block tile cols: one thread per column
constexpr int BK = 32;   // k step staged in shared memory

template <typename TIn, typename TOut, int ACT>
__global__ void __launch_bounds__(BN)
vpu_mm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
              const float* __restrict__ bias, TOut* __restrict__ c, int m,
              int n, int k) {
  // A slice, k-major: As[kk] is the column A[row0:row0+BM, k0+kk]
  __shared__ __align__(16) float As[BK][BM];

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col = blockIdx.y * BN + tid;
  const bool col_ok = col < n;

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    const int kn = min(BK, k - k0);
    // consecutive threads read consecutive k of one row of A
#pragma unroll
    for (int l = 0; l < (BM * BK) / BN; ++l) {
      const int idx = tid + l * BN;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int64_t gr = row0 + r;
      As[kk][r] = (gr < m && kk < kn) ? to_f32(a[gr * k + k0 + kk]) : 0.0f;
    }
    __syncthreads();
    if (col_ok) {
      for (int kk = 0; kk < kn; ++kk) {
        const float bv = to_f32(b[(int64_t)(k0 + kk) * n + col]);
#pragma unroll
        for (int i = 0; i < BM; i += 4) {
          const float4 av = *reinterpret_cast<const float4*>(&As[kk][i]);
          acc[i + 0] = fmaf(av.x, bv, acc[i + 0]);
          acc[i + 1] = fmaf(av.y, bv, acc[i + 1]);
          acc[i + 2] = fmaf(av.z, bv, acc[i + 2]);
          acc[i + 3] = fmaf(av.w, bv, acc[i + 3]);
        }
      }
    }
    __syncthreads();
  }

  if (!col_ok) return;
  const float bj = bias_at(bias, col);
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int64_t gr = row0 + i;
    if (gr < m) epilogue_store<ACT>(&c[gr * n + col], acc[i], bj);
  }
}

}  // namespace

// a, b: row-major (m, k) and (k, n), both of in_dtype; bias: fp32 (n,) or
// null; c: row-major (m, n) of out_dtype.  m, n >= 1, k >= 0.
extern "C" int vpu_mm(const void* a, const void* b, const void* bias,
                      void* c, int m, int n, int k, int in_dtype,
                      int out_dtype, int act, void* stream) {
  if (!gemm_args_ok(m, n, k, in_dtype, out_dtype, act)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_gemm(in_dtype, out_dtype, act, [&](auto in, auto out, auto fused) {
    using TIn = decltype(in);
    using TOut = decltype(out);
    vpu_mm_kernel<TIn, TOut, decltype(fused)::value><<<grid, BN, 0, s>>>(
        static_cast<const TIn*>(a), static_cast<const TIn*>(b),
        static_cast<const float*>(bias), static_cast<TOut*>(c), m, n, k);
  });
  return (int)cudaGetLastError();
}
