// qmm: C[m, n] = act((A_q[m, k] @ W_q[k, n]) * scale[n] + bias[n]) with int8
// operands and an exact int32 accumulator, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/qmm/qmm.py::qmm_pallas, the
// quantized engine family's int8 x int8 path: A quantized per tensor, W per
// output channel, the int32 sum never rounded, and the dequant (the per-
// column scale, which already holds w_scale * act_scale), bias and
// activation fused into the epilogue.  In raw mode (out_dtype DT_I32) the
// epilogue is skipped and the int32 accumulator is stored: the runtime
// splits a GEMM into row panels in that mode and dequantizes once after
// the merge.
//
// What bounds it on an H100: every CIFAR_Alex+ GEMM is bound by bytes (the
// int8 tensor cores do 1,979 TOP/s; HBM moves 3.35 TB/s), and the fp32
// output is the largest stream (conv2: 7 MB of A and W against 17 MB of C).
//
// What the design does about it: this first version is simple and right.
// Each 256-thread block owns a 64 x 64 output tile and walks k in steps of
// 32, staging A row-major and W transposed (k contiguous per column) in
// shared memory, so that a thread reads four k values of one row or one
// column as one 32-bit word and feeds them to __dp4a (four int8 products
// added to an int32 in one instruction, on the CUDA cores).  Each thread
// keeps a 4 x 4 int32 micro-tile; C is written once, in its final type.
// Ragged edges are masked in the loads (out-of-range int8 values are staged
// as 0, which adds exactly 0) and in the stores; nothing is padded in
// device memory.  -128 is accepted in either operand.  Making it fast
// (mma/wgmma IMMA, TMA, quantization fused into im2col) is later work;
// integer sums are exact in any order, so a faster version changes no bit.
//
// The epilogue's rounding is spelled out: with a bias, fmaf(float(acc),
// scale, bias) rounds once (as repro's XLA-contracted epilogue does);
// without one, __fmul_rn(float(acc), scale).  Nothing is left to nvcc's
// contraction.  The scale and bias are device pointers read at run time,
// so a new activation scale never rebuilds the kernel.
//
// Interface: plain C, bound with ctypes.  The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the function returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

using namespace synergy;

constexpr int DT_I32 = 2;           // raw int32 accumulator, no epilogue
constexpr int BM = 64;              // block tile rows
constexpr int BN = 64;              // block tile cols
constexpr int BK = 32;              // k step staged in shared memory (bytes)
constexpr int TM = 4;               // rows per thread
constexpr int TN = 4;               // cols per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int LDS = BK + 4;         // row stride in bytes: 9 words, odd, so
                                    // the 16 columns a half-warp reads fall
                                    // in 16 different banks

// RAW: store the int32 sum.  Otherwise act(sum * scale + bias) in TOut.
template <typename TOut, int ACT, bool RAW>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ bias,
           TOut* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) int8_t As[BM][LDS];   // A[row][k]
  __shared__ __align__(16) int8_t Ws[BN][LDS];   // W[k][col], transposed

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // column lane: cols tx + 16 * j
  const int ty = tid / (BN / TN);   // row lane: rows ty + 16 * i
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A slice, BM x BK: consecutive threads read consecutive k of one row.
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int64_t gr = row0 + r;
      const int gk = k0 + kk;
      As[r][kk] = (gr < m && gk < k) ? a[gr * k + gk] : (int8_t)0;
    }
    // W slice, BK x BN: consecutive threads read consecutive columns.
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int kk = idx / BN;
      const int cc = idx % BN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      Ws[cc][kk] = (gk < k && gc < n) ? w[(int64_t)gk * n + gc] : (int8_t)0;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      int av[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const int*>(&As[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        wv[j] = *reinterpret_cast<const int*>(&Ws[tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gc = col0 + tx + 16 * j;
    if (gc >= n) continue;
    float s = 0.0f, b = 0.0f;
    if (!RAW) {
      s = scale[gc];
      b = bias_at(bias, gc);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gr = row0 + ty + 16 * i;
      if (gr >= m) continue;
      if constexpr (RAW) {
        c[gr * n + gc] = acc[i][j];
      } else {
        const float x = __int2float_rn(acc[i][j]);
        const float y = bias != nullptr ? fmaf(x, s, b) : __fmul_rn(x, s);
        store(&c[gr * n + gc], activate<ACT>(y));
      }
    }
  }
}

template <typename TOut, int ACT, bool RAW>
void launch(const void* a, const void* w, const void* scale,
            const void* bias, void* c, int m, int n, int k,
            cudaStream_t s) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  qmm_kernel<TOut, ACT, RAW><<<grid, THREADS, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TOut*>(c), m, n, k);
}

template <typename TOut>
void launch_act(int act, const void* a, const void* w, const void* scale,
                const void* bias, void* c, int m, int n, int k,
                cudaStream_t s) {
  switch (act) {
    case ACT_RELU:
      launch<TOut, ACT_RELU, false>(a, w, scale, bias, c, m, n, k, s);
      break;
    case ACT_SILU:
      launch<TOut, ACT_SILU, false>(a, w, scale, bias, c, m, n, k, s);
      break;
    default:
      launch<TOut, ACT_NONE, false>(a, w, scale, bias, c, m, n, k, s);
      break;
  }
}

}  // namespace

// a, w: row-major int8 (m, k) and (k, n); scale: fp32 (n,), the dequant
// multiplier (w_scale * act_scale), unread in raw mode; bias: fp32 (n,) or
// null; c: row-major (m, n) of out_dtype (DT_F32, DT_BF16, or DT_I32 for
// the raw accumulator, which ignores scale, bias and act).
// m, n >= 1, k >= 0.
extern "C" int qmm(const void* a, const void* w, const void* scale,
                   const void* bias, void* c, int m, int n, int k,
                   int out_dtype, int act, void* stream) {
  if (m < 1 || n < 1 || k < 0 || act < ACT_NONE || act > ACT_SILU ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16 && out_dtype != DT_I32) ||
      (out_dtype != DT_I32 && scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == DT_I32) {
    launch<int32_t, ACT_NONE, true>(a, w, scale, bias, c, m, n, k, s);
  } else if (out_dtype == DT_F32) {
    launch_act<float>(act, a, w, scale, bias, c, m, n, k, s);
  } else {
    launch_act<__nv_bfloat16>(act, a, w, scale, bias, c, m, n, k, s);
  }
  return (int)cudaGetLastError();
}
