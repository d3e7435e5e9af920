// flash_attention: O = softmax(Q K^T * scale) V per (batch, q-head), causal
// or full, with grouped-query heads, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py::flash_attention_pallas: one query tile streams the
// key/value tiles of its kv head (h / group, so K/V are never repeated in
// memory) with an online softmax.  m, l and the output accumulator stay in
// fp32; p is rounded to V's type before the PV product, as the Pallas
// kernel's p.astype(v.dtype) does, while l sums the unrounded p; the output
// is acc / max(l, 1e-30) in Q's type.  The causal mask is the Pallas
// kernel's: global row >= global col, and kv tiles wholly above the
// diagonal are never loaded.
//
// What bounds it on an H100: at the zoo's prefill shapes (zamba2: B 4,
// H 32, S 1024, D 80, causal) the bytes of q, k, v and o (84 MB in bf16,
// 25 us at 3.35 TB/s) and the causal products (21.5 GFLOP, 22 us on the
// bf16 tensor cores) are close; this kernel does its products with FFMA on
// the CUDA cores, so the operations bound it (at least ~320 us at 67
// TFLOP/s).
//
// What the design does about it: this first version is simple and right.
// One 256-thread block owns 64 query rows of one (batch, head) and walks
// the kv tiles of 64 keys.  Q (64 x D), K (64 x D) and V (64 x D) are
// staged in shared memory as fp32, Q and K with a row stride of D + 1 so
// that the 16 keys a half-warp reads fall in 16 banks; the 64 x 64 score
// tile goes through shared memory too (stride 65), where four threads
// share one row for its max and sum (two shuffles each).  Each thread keeps
// a 4 x 4 micro-tile of S and a 4 x (D / 16) tile of the accumulator in
// registers.  Ragged S and Sk are masked in the kernel: query rows past S
// are zero and never stored, keys past Sk are zero and get score -1e30.
// At D = 256 the staging takes 210 KB of the 227 KB a block may use.
// Tensor cores (mma/wgmma), TMA and a K/V ring are later work.
//
// Interface: plain C, bound with ctypes.  The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the function returns
// the CUDA error of the launch so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

using namespace synergy;

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per kv tile
constexpr int THREADS = 256;
constexpr int PLD = BK + 1;         // row stride of the score tile
constexpr float NEG = -1e30f;       // the Pallas kernel's masked score

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PLD + 3 * BQ);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int s, int sk, float scale) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;        // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x LD
  float* Ks = Qs + BQ * LD;         // BK x LD
  float* Vs = Ks + BK * LD;         // BK x D
  float* Ps = Vs + BK * D;          // BQ x PLD: scores, then p
  float* m_s = Ps + BQ * PLD;       // running row max
  float* l_s = m_s + BQ;            // running row sum
  float* a_s = l_s + BQ;            // this tile's rescale exp(m_prev - m_new)

  const int tid = threadIdx.x;
  const int ty = tid / 16;          // rows 4 ty .. 4 ty + 3 of S and O
  const int tx = tid % 16;          // cols tx + 16 j of S and O
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t qoff = ((int64_t)b * hq + h) * s * D;
  const int64_t koff = ((int64_t)b * hkv + hk) * sk * D;
  const T* qp = q + qoff;
  const T* kp = k + koff;
  const T* vp = v + koff;
  T* op = o + qoff;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    Qs[r * LD + c] =
        q0 + r < s ? to_f32(qp[(int64_t)(q0 + r) * D + c]) : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.0f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  // kv tiles wholly above the diagonal hold no key any row of this block
  // may see: the loop stops before them
  const int kv_end = CAUSAL ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                // the last tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < sk;
      const int64_t at = (int64_t)(k0 + r) * D + c;
      Ks[r * LD + c] = in ? to_f32(kp[at]) : 0.0f;
      Vs[r * D + c] = in ? to_f32(vp[at]) : 0.0f;
    }
    __syncthreads();

    // S = Q K^T * scale, masked
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int gc = k0 + c;
        const bool keep = gc < sk && (!CAUSAL || q0 + r >= gc);
        Ps[r * PLD + c] = keep ? sc[i][j] * scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 columns each
    {
      const int r = tid / 4;
      float* prow = Ps + r * PLD + (tid % 4) * 16;
      const float m_prev = m_s[r];
      const float l_prev = l_s[r];
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) mx = fmaxf(mx, prow[jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const float p = expf(prow[jj] - m_new);
        sum += p;
        prow[jj] = round_as<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();                 // every lane has read m_s[r], l_s[r]
      if (tid % 4 == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_prev * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over the keys this block may see (p is
    // exactly 0 beyond them)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[4 * ty + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    const int kk_end = min(BK, kv_end - k0);
#pragma unroll 4
    for (int kk = 0; kk < kk_end; ++kk) {
      float pa[4], vb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(4 * ty + i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (q0 + r >= s) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = op + (int64_t)(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(&orow[tx + 16 * j], acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, int sk, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = causal ? flash_attention_kernel<T, D, true>
                       : flash_attention_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s, sk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int b, int hq, int hkv, int s, int sk, float scale, int causal,
             cudaStream_t st) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    case 80: return launch<T, 80>(q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    case 112: return launch<T, 112>(q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    case 256: return launch<T, 256>(q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, hq, s, d); k, v: (b, hkv, sk, d); o: like q; all contiguous and of
// one dtype (DT_F32 or DT_BF16).  hq % hkv == 0; d one of 64, 80, 112, 128,
// 256.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int hq, int hkv, int s,
                               int sk, int d, float scale, int causal,
                               int dtype, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || s < 1 || sk < 1 || hq % hkv != 0 ||
      b > 65535 || hq > 65535 || (dtype != DT_F32 && dtype != DT_BF16)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    return launch_d<float>(d, q, k, v, o, b, hq, hkv, s, sk, scale, causal,
                           st);
  }
  return launch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, s, sk, scale,
                                 causal, st);
}
