// vpu_mm: C[m, n] = act(A[m, k] @ B[k, n] + bias[n]) for Hopper (sm_90a),
// on the CUDA cores only.
//
// Replaces the TPU kernel src/repro/kernels/vpu_mm/vpu_mm.py::vpu_mm_pallas,
// the MXU-free matmul that stands for the paper's NEON SIMD cores: the
// pool's slow, always-available engine.  Like the Pallas kernel it never
// touches the matrix unit: no mma, wgmma or other tensor-core instruction,
// only FFMA (chip_smoke.py checks the SASS for HMMA/GMMA/IMMA).  What makes
// it the pool's slow member is the engine's cost model (a sixteenth of
// cuda-tiled's rate) and the absence of the tensor cores, not a careless
// loop: with TF32 off, an fp32 GEMM on this card runs on FFMA in any
// library too.  On the runtime's 32-row panels its tile below runs faster
// than tiled_mm's own, with the same bits.
//
// What bounds it on an H100: the fp32 FMA rate of the CUDA cores (67
// TFLOP/s dense on the SXM part) for the wide-k GEMMs, device-memory bytes
// (3.35 TB/s) for thin k.  Its main path is the runtime's 32-row row
// panels (the paper's TS), where neither bound is near: a panel holds only
// 32 x n outputs, each a chain of k dependent FMAs, so the time is the
// longest chain of instructions one warp issues.
//
// What the design does about it: the mainloop is K1's register-blocked
// FFMA loop (common/ffma_gemm.cuh: a cp.async ring, a register micro-tile
// per thread, bf16 staged as bf16 and widened when read).  GEMMs whose
// 128-row tiles fill the card take K1's tiles (8 x 8 outputs a thread).
// Smaller ones (the 32-row panels, the FC layers) are too few outputs to
// share registers across: a conv2 panel (32 x 64, k = 1,600) holds 2,048
// chains of 1,600 dependent FMAs, and a thread that owns 16 of them (K1's
// 32 x 64 tile of 4 x 4) issues 16 times the instructions of one that owns
// one.  So they take 16 x 8 tiles of one output a thread, k steps of 32
// through six buffers: the panel spreads over 16 blocks of 128 threads,
// and five k steps are in flight to cover the latency of L2.
//
// Determinism: every output starts from 0.0f and takes one fmaf per k in
// increasing k, and the epilogue is the shared device function of
// common/epilogue.cuh, exactly as in tiled_mm.cu.  So an output's bits do
// not depend on the tile it lies in, on the row panel it was computed in,
// or on which of the two kernels computed it.  Ragged edges are masked in
// the loads and the stores; nothing is padded.
//
// Interface: plain C, bound with ctypes, the same as tiled_mm's.  The
// launch goes on the caller's stream, allocates nothing and does not
// synchronise; the function returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "ffma_gemm.cuh"

namespace {

using namespace synergy;

// 16 x 8 outputs, one a thread: the row panels and the FC layers
using Panel = ffma::Tile<16, 8, 1, 1, 1, 32, 6>;

template <typename T, typename TIn, typename TOut, int ACT>
__global__ void __launch_bounds__(T::THREADS)
vpu_mm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
              const float* __restrict__ bias, TOut* __restrict__ c, int m,
              int n, int k) {
  extern __shared__ __align__(16) unsigned char vpu_smem[];
  ffma::gemm<T, TIn, TOut, ACT>(a, b, bias, c, m, n, k,
                                reinterpret_cast<TIn*>(vpu_smem));
}

// The tile never changes an output's bits, so it follows the shape: K1's
// 128-row tiles while they reach half the SMs, else Panel.
template <typename TIn, typename TOut, int ACT>
int launch(const TIn* a, const TIn* b, const float* bias, TOut* c, int m,
           int n, int k, cudaStream_t s) {
  if (!ffma::big_tiles_fill_card(m, n)) {
    return ffma::launch_tile<Panel>(vpu_mm_kernel<Panel, TIn, TOut, ACT>, a,
                                    b, bias, c, m, n, k, s);
  }
  if (n <= 64) {
    return ffma::launch_tile<ffma::Narrow>(
        vpu_mm_kernel<ffma::Narrow, TIn, TOut, ACT>, a, b, bias, c, m, n, k,
        s);
  }
  return ffma::launch_tile<ffma::Wide>(
      vpu_mm_kernel<ffma::Wide, TIn, TOut, ACT>, a, b, bias, c, m, n, k, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaSuccess;
  dispatch_gemm(in_dtype, out_dtype, act, [&](auto in, auto out, auto fused) {
    using TIn = decltype(in);
    using TOut = decltype(out);
    rc = launch<TIn, TOut, decltype(fused)::value>(
        static_cast<const TIn*>(a), static_cast<const TIn*>(b),
        static_cast<const float*>(bias), static_cast<TOut*>(c), m, n, k, s);
  });
  if (rc != (int)cudaSuccess) return rc;
  return (int)cudaGetLastError();
}
