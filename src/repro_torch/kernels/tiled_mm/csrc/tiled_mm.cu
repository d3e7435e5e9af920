// tiled_mm: C[m, n] = act(A[m, k] @ B[k, n] + bias[n]) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tiled_mm/tiled_mm.py::
// tiled_mm_pallas, the Synergy processing engine: a tiled matrix product
// with an fp32 accumulator and bias + activation fused into the epilogue.
// Three paths, chosen by (n, k, input type) only and never by m, so that a
// row panel computed alone takes the whole GEMM's path (tiled_mm_path):
//
// fp32 inputs -> "ffma", on the CUDA cores.  The reference holds fp32
// GEMMs to 1e-5 and TF32 keeps about three decimal digits, so the bound is
// the fp32 FMA rate (67 TFLOP/s dense on the SXM part) for wide k (the
// paper CNNs' conv2..conv4, k = 1600) and device-memory bytes (3.35 TB/s)
// for thin k (conv1 after im2col, k = 75, ~2 FLOP per byte).  A block owns
// a 128 x 128 tile (128 x 64 when n <= 64, the paper CNNs' first convs), a
// thread an 8 x 8 register micro-tile; GEMMs too short to fill half the
// card with such tiles (the FC layers, the runtime's 32-row panels) take
// 32 x 64 tiles of 4 x 4.  k walks in steps of 16 staged by cp.async
// through four shared-memory buffers, so three steps load while one
// multiplies: the mainloop of common/ffma_gemm.cuh, which vpu_mm.cu (K3)
// runs with its own tiles.  Every output sums its k products from 0.0f
// with one fmaf per k in increasing k, whatever the tile: a row panel
// gives the whole GEMM's bits, and the runtime merges panels of both
// kernels bitwise.
//
// bf16 inputs, k % 8 == 0 and n % 8 == 0 -> "wgmma", on the tensor cores
// (989 TFLOP/s dense): warpgroup MMA fed by TMA through a four-stage ring,
// wgmma_gemm.cuh.  Every GEMM of the LM zoo at published widths is aligned.
// At m = 4096 they are bound by the tensor cores; at decode's m = 4, by the
// bytes of B.
//
// other bf16 shapes -> "mma": rows of A or B are not 16-byte aligned, so
// TMA cannot read them.  A block owns a 64 x 64 tile, staged by plain
// masked loads, and four warps run mma.sync m16n8k16 over k steps of 32.
// Only ragged shapes take it (no GEMM of the zoo or the paper CNNs in bf16).
//
// On both bf16 paths the k steps run in one order for every row, whichever
// tile holds it, so a row panel gives the whole GEMM's bits on its path.
// The epilogue (common/epilogue.cuh) runs on the accumulator registers and
// writes C once, in its final type; ragged edges are masked, nothing is
// padded in device memory.
//
// Interface: plain C, bound with ctypes.  The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the function returns
// the CUDA error of the launch so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "epilogue.cuh"
#include "ffma_gemm.cuh"
#include "ptx.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace synergy;

enum Path { PATH_FFMA = 0, PATH_MMA = 1, PATH_WGMMA = 2 };

int choose_path(int n, int k, int in_dtype) {
  if (in_dtype == DT_F32) return PATH_FFMA;
  return (k > 0 && k % 8 == 0 && n % 8 == 0) ? PATH_WGMMA : PATH_MMA;
}

// ---------------------------------------------------------------- ffma

// The mainloop is common/ffma_gemm.cuh, shared with vpu_mm.cu (K3); this
// kernel's own tiles are Wide, Narrow and Small there.
template <typename T, typename TOut, int ACT>
__global__ void __launch_bounds__(T::THREADS)
tiled_mm_ffma_kernel(const float* __restrict__ a,
                     const float* __restrict__ b,
                     const float* __restrict__ bias, TOut* __restrict__ c,
                     int m, int n, int k) {
  extern __shared__ __align__(16) float ffma_smem[];
  ffma::gemm<T, float, TOut, ACT>(a, b, bias, c, m, n, k, ffma_smem);
}

// The tile never changes an output's bits (one fmaf per k in increasing
// k, whatever the tile), so it may follow m: a 128-row tile while its grid
// still reaches half the SMs, else 32 rows (the FC layers and the
// runtime's 32-row panels, which a 128-row tile would leave 3/4 idle).
template <typename TOut, int ACT>
int launch_ffma(const float* a, const float* b, const float* bias, TOut* c,
                int m, int n, int k, cudaStream_t s) {
  if (!ffma::big_tiles_fill_card(m, n)) {
    return ffma::launch_tile<ffma::Small>(
        tiled_mm_ffma_kernel<ffma::Small, TOut, ACT>, a, b, bias, c, m, n, k,
        s);
  }
  if (n <= 64) {
    return ffma::launch_tile<ffma::Narrow>(
        tiled_mm_ffma_kernel<ffma::Narrow, TOut, ACT>, a, b, bias, c, m, n,
        k, s);
  }
  return ffma::launch_tile<ffma::Wide>(
      tiled_mm_ffma_kernel<ffma::Wide, TOut, ACT>, a, b, bias, c, m, n, k, s);
}

// ----------------------------------------------------------------- mma

namespace mma {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LD = BK + 8;          // row stride in bf16: 4-byte aligned
constexpr int THREADS = 128;        // 2 x 2 warps of 32 x 32

// B is stored transposed ([n][k]), so both operands' fragments are pairs
// of neighbouring k in one 32-bit word.
template <typename TOut, int ACT>
__global__ void __launch_bounds__(THREADS)
tiled_mm_mma_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    const float* __restrict__ bias, TOut* __restrict__ c,
                    int m, int n, int k) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LD];
  __shared__ __align__(16) __nv_bfloat16 Bt[BN][LD];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (tid / 32) / 2, wn = (tid / 32) % 2;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK, kk = idx % BK;
      As[r][kk] = (row0 + r < m && k0 + kk < k)
                      ? a[(row0 + r) * k + k0 + kk]
                      : zero;
    }
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int kk = idx / BN, cc = idx % BN;
      Bt[cc][kk] = (k0 + kk < k && col0 + cc < n)
                       ? b[(int64_t)(k0 + kk) * n + col0 + cc]
                       : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = 32 * wm + 16 * mi + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 2 * t]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 2 * t]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 2 * t + 8]);
        af[mi][3] =
            *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cn = 32 * wn + 8 * ni + g;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&Bt[cn][ks + 2 * t]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&Bt[cn][ks + 2 * t + 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16_16816(acc[mi][ni], af[mi], b0, b1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gc = col0 + 32 * wn + 8 * ni + 2 * t + (e % 2);
      if (gc >= n) continue;
      const float bc = bias_at(bias, gc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int64_t gr = row0 + 32 * wm + 16 * mi + g + 8 * (e / 2);
        if (gr < m) epilogue_store<ACT>(&c[gr * n + gc], acc[mi][ni][e], bc);
      }
    }
  }
}

template <typename TOut, int ACT>
void launch(const __nv_bfloat16* a, const __nv_bfloat16* b,
            const float* bias, TOut* c, int m, int n, int k,
            cudaStream_t s) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  tiled_mm_mma_kernel<TOut, ACT><<<grid, THREADS, 0, s>>>(a, b, bias, c, m,
                                                           n, k);
}

}  // namespace mma

}  // namespace

// Which path a GEMM of this (n, k, input dtype) takes: 0 ffma, 1 mma,
// 2 wgmma.  m plays no part.
extern "C" int tiled_mm_path(int n, int k, int in_dtype) {
  return choose_path(n, k, in_dtype);
}

// a, b: row-major (m, k) and (k, n), both of in_dtype; bias: fp32 (n,) or
// null; c: row-major (m, n) of out_dtype.  m, n >= 1, k >= 0.  The wgmma
// path needs a and b on 16-byte boundaries.
extern "C" int tiled_mm(const void* a, const void* b, const void* bias,
                        void* c, int m, int n, int k, int in_dtype,
                        int out_dtype, int act, void* stream) {
  if (!gemm_args_ok(m, n, k, in_dtype, out_dtype, act)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fbias = static_cast<const float*>(bias);
  int rc = (int)cudaSuccess;
  dispatch_gemm(in_dtype, out_dtype, act, [&](auto in, auto out, auto fused) {
    using TIn = decltype(in);
    using TOut = decltype(out);
    constexpr int ACT = decltype(fused)::value;
    TOut* cc = static_cast<TOut*>(c);
    if constexpr (std::is_same<TIn, float>::value) {
      rc = launch_ffma<TOut, ACT>(static_cast<const float*>(a),
                                  static_cast<const float*>(b), fbias, cc, m,
                                  n, k, s);
    } else if (choose_path(n, k, in_dtype) == PATH_WGMMA) {
      rc = wgmma_gemm::launch<TOut, ACT>(a, b, fbias, cc, m, n, k, s);
    } else {
      mma::launch<TOut, ACT>(static_cast<const __nv_bfloat16*>(a),
                             static_cast<const __nv_bfloat16*>(b), fbias, cc,
                             m, n, k, s);
    }
  });
  if (rc != (int)cudaSuccess) return rc;
  return (int)cudaGetLastError();
}
