// tiled_mm: C[m, n] = act(A[m, k] @ B[k, n] + bias[n]) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tiled_mm/tiled_mm.py::
// tiled_mm_pallas, the Synergy processing engine: a tiled matrix product
// with an fp32 accumulator and bias + activation fused into the epilogue.
//
// What bounds it on an H100: the kernel runs in full fp32 on the CUDA cores
// (FFMA, 67 TFLOP/s dense on the SXM part), because the reference holds
// fp32 GEMMs to 1e-5 and TF32 tensor cores keep about three decimal digits.
// Wide-k GEMMs (the paper CNNs' conv2..conv4, k = 1600) are bound by that
// FMA rate; thin-k GEMMs (conv1 after im2col, k = 75) do ~2 FLOP per byte
// and are bound by device-memory bytes (3.35 TB/s).
//
// What the design does about it: each 256-thread block owns a 64 x 64
// output tile and walks k in steps of 16, staging the A and B slices through
// shared memory so that every element read from device memory feeds 64
// FMAs; each thread keeps a 4 x 4 register micro-tile, read from shared
// memory as float4 pairs (8 shared loads per 16 FMAs).  The epilogue runs
// on the register tile, so C is written to device memory once, in its
// final type.  Ragged edges are masked in the loads and stores; nothing is
// padded in device memory.  Making it fast (wgmma, TMA, a multi-stage
// ring) is later work.
//
// Determinism: every output element sums its k products in increasing k
// order with one fmaf per step, independent of which block or row panel
// it lies in, so a row panel computed alone gives the same bits as the
// whole GEMM.  The job tile of the Python API does not reach the kernel.
//
// Interface: plain C, bound with ctypes.  The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // block tile rows
constexpr int BN = 64;              // block tile cols
constexpr int BK = 16;              // k step staged in shared memory
constexpr int TM = 4;               // register micro-tile rows per thread
constexpr int TN = 4;               // register micro-tile cols per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int A_PAD = 4;            // keeps float4 alignment, spreads banks

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == ACT_RELU) return fmaxf(y, 0.0f);
  if (ACT == ACT_SILU) return y / (1.0f + expf(-y));
  return y;
}

template <typename TIn, typename TOut, int ACT>
__global__ void __launch_bounds__(THREADS)
tiled_mm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                const float* __restrict__ bias, TOut* __restrict__ c,
                int m, int n, int k) {
  // A is stored k-major so that a thread's TM rows are one float4.
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // which TN-column group
  const int ty = tid / (BN / TN);   // which TM-row group
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A slice: BM x BK, consecutive threads read consecutive k of one row.
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int64_t gr = row0 + r;
      const int gk = k0 + kk;
      As[kk][r] = (gr < m && gk < k) ? to_f32(a[gr * k + gk]) : 0.0f;
    }
    // B slice: BK x BN, consecutive threads read consecutive columns.
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int kk = idx / BN;
      const int cc = idx % BN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      Bs[kk][cc] = (gk < k && gc < n) ? to_f32(b[(int64_t)gk * n + gc])
                                      : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gc = col0 + tx * TN + j;
    if (gc >= n) continue;
    const float bj = bias != nullptr ? bias[gc] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gr = row0 + ty * TM + i;
      if (gr < m) store(&c[gr * n + gc], activate<ACT>(acc[i][j] + bj));
    }
  }
}

template <typename TIn, typename TOut>
void launch_typed(const void* a, const void* b, const float* bias, void* c,
                  int m, int n, int k, int act, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  const TIn* ap = static_cast<const TIn*>(a);
  const TIn* bp = static_cast<const TIn*>(b);
  TOut* cp = static_cast<TOut*>(c);
  switch (act) {
    case ACT_RELU:
      tiled_mm_kernel<TIn, TOut, ACT_RELU>
          <<<grid, THREADS, 0, stream>>>(ap, bp, bias, cp, m, n, k);
      break;
    case ACT_SILU:
      tiled_mm_kernel<TIn, TOut, ACT_SILU>
          <<<grid, THREADS, 0, stream>>>(ap, bp, bias, cp, m, n, k);
      break;
    default:
      tiled_mm_kernel<TIn, TOut, ACT_NONE>
          <<<grid, THREADS, 0, stream>>>(ap, bp, bias, cp, m, n, k);
      break;
  }
}

}  // namespace

// a, b: row-major (m, k) and (k, n), both of in_dtype; bias: fp32 (n,) or
// null; c: row-major (m, n) of out_dtype.  m, n >= 1, k >= 0.
extern "C" int tiled_mm(const void* a, const void* b, const void* bias,
                        void* c, int m, int n, int k, int in_dtype,
                        int out_dtype, int act, void* stream) {
  if (m < 1 || n < 1 || k < 0 || act < ACT_NONE || act > ACT_SILU ||
      (in_dtype != DT_F32 && in_dtype != DT_BF16) ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* biasp = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_F32 && out_dtype == DT_F32) {
    launch_typed<float, float>(a, b, biasp, c, m, n, k, act, s);
  } else if (in_dtype == DT_F32) {
    launch_typed<float, __nv_bfloat16>(a, b, biasp, c, m, n, k, act, s);
  } else if (out_dtype == DT_F32) {
    launch_typed<__nv_bfloat16, float>(a, b, biasp, c, m, n, k, act, s);
  } else {
    launch_typed<__nv_bfloat16, __nv_bfloat16>(a, b, biasp, c, m, n, k, act,
                                               s);
  }
  return (int)cudaGetLastError();
}
