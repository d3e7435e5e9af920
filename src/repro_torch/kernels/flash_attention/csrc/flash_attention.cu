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
// kernel's: global row >= global col, masked scores are -1e30, and kv
// tiles wholly above the diagonal are never loaded.  Ragged S and Sk are
// masked in the kernel: query rows past S are zero and never stored, keys
// past Sk are zero and score -1e30.
//
// What bounds it on an H100: at the zoo's prefill shapes (zamba2: B 4,
// H 32, S 1024, D 80, causal) the bytes of q, k, v and o (84 MB in bf16,
// 25 us at 3.35 TB/s) and the causal products (21.5 GFLOP, 22 us on the
// bf16 tensor cores) are close.
//
// bf16 (the zoo's compute type): FlashAttention-2 on the tensor cores.  A
// 128-thread block owns 64 query rows, each warp 16 of them, whose Q stays
// in registers as mma.sync m16n8k16 A fragments for the whole kv walk.  K
// and V tiles of 64 keys (32 at D = 256, for registers) are double-
// buffered in shared memory by cp.async, so the next tile loads while this
// one multiplies; rows are padded by 16 bytes so that ldmatrix meets no
// bank conflict.  S = Q K^T stays in registers (ldmatrix of K as the B
// operand), the online softmax runs on the accumulator registers with the
// row max and sum across the four lanes of a quad (two shuffles), in units
// of log2 so that each exp is one exp2, masking only the tiles that cross
// the diagonal or the end of the keys, and P is rounded to bf16 in
// registers, where the S accumulator layout of two
// neighbouring 8-key tiles is exactly the A fragment of the PV product (V
// through ldmatrix.trans).  Head dims are multiples of 16, so no padding.
// Blocks are handed out longest causal rows first.
//
// fp32: the reference's 2e-5 rules out TF32, so this path runs FFMA on the
// CUDA cores (operations bound it, ~320 us at 67 TFLOP/s for the shape
// above).  One 256-thread block owns 64 query rows and walks kv tiles of
// 64 keys; Q, K and V are staged in shared memory, Q and K with a row
// stride of D + 1 so that the 16 keys a half-warp reads fall in 16 banks;
// the 64 x 64 score tile goes through shared memory too (stride 65), where
// four threads share one row for its max and sum.  Each thread keeps a
// 4 x 4 micro-tile of S and a 4 x (D / 16) tile of the accumulator.  At
// D = 256 the staging takes 210 KB of the 227 KB a block may use.
//
// Interface: plain C, bound with ctypes.  The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the function returns
// the CUDA error of the launch so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "ptx.cuh"

namespace {

using namespace synergy;

constexpr float NEG = -1e30f;       // the Pallas kernel's masked score

// ------------------------------------------------- fp32: FFMA, CUDA cores

namespace ffma {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per kv tile
constexpr int THREADS = 256;
constexpr int PLD = BK + 1;         // row stride of the score tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PLD + 3 * BQ);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_attention_ffma_kernel(const T* __restrict__ q,
                            const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            int hq, int hkv, int s, int sk, float scale) {
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
  auto kernel = causal ? flash_attention_ffma_kernel<T, D, true>
                       : flash_attention_ffma_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s, sk, scale);
  return (int)cudaGetLastError();
}

}  // namespace ffma

// ------------------------------------ bf16: mma.sync on the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;              // query rows per block, 16 per warp
constexpr int THREADS = 2 * BQ;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int BKV = D <= 128 ? 64 : 32;   // keys per kv tile
  static constexpr int LD = D + 8;                 // bf16: rows 16 B apart
  static constexpr size_t SMEM = sizeof(bf16) * LD * (BQ + 4 * BKV);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           int hq, int hkv, int s, int sk, float scale) {
  constexpr int BKV = Tile<D>::BKV;
  constexpr int LD = Tile<D>::LD;
  constexpr int KS = D / 16;        // k16 steps of Q K^T
  constexpr int NT = BKV / 8;       // 8-key tiles of S per warp
  constexpr int ND = D / 8;         // 8-column tiles of O per warp
  constexpr int CH = D / 8;         // 16-byte chunks per row
  extern __shared__ __align__(16) bf16 sm[];
  bf16* Qs = sm;                    // BQ x LD
  bf16* Ks = Qs + BQ * LD;          // 2 x BKV x LD
  bf16* Vs = Ks + 2 * BKV * LD;     // 2 x BKV x LD

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const bf16* qp = q + ((int64_t)b * hq + h) * s * D;
  const bf16* kp = k + ((int64_t)b * hkv + hk) * sk * D;
  const bf16* vp = v + ((int64_t)b * hkv + hk) * sk * D;
  bf16* op = o + ((int64_t)b * hq + h) * s * D;

  for (int idx = tid; idx < BQ * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool in = q0 + r < s;
    cp_async16(Qs + r * LD + 8 * c,
               in ? qp + (int64_t)(q0 + r) * D + 8 * c : qp, in ? 16 : 0);
  }
  cp_async_commit();
  auto stage_kv = [&](int buf, int k0) {
    for (int idx = tid; idx < BKV * CH; idx += THREADS) {
      const int r = idx / CH, c = idx % CH;
      const bool in = k0 + r < sk;
      const int64_t at = (int64_t)(k0 + r) * D + 8 * c;
      const int dst = (buf * BKV + r) * LD + 8 * c;
      cp_async16(Ks + dst, in ? kp + at : kp, in ? 16 : 0);
      cp_async16(Vs + dst, in ? vp + at : vp, in ? 16 : 0);
    }
    cp_async_commit();
  };

  // kv tiles wholly above the diagonal hold no key any row of this block
  // may see: the walk stops before them
  const int kv_end = CAUSAL ? min(sk, q0 + BQ) : sk;
  const int tiles = (kv_end + BKV - 1) / BKV;
  stage_kv(0, 0);
  cp_async_wait<1>();               // Q has landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int row = 16 * warp + lane % 8 + 8 * ((lane / 8) % 2);
    ldmatrix_x4(qf[ks], Qs + row * LD + 16 * ks + 8 * (lane / 16));
  }

  // this thread's rows: qrow (accumulator elements 0, 1) and qrow + 8
  const int qrow = q0 + 16 * warp + g;
  const float scale_log2 = scale * LOG2E;
  float m_run[2] = {NEG, NEG};
  float l_run[2] = {0.0f, 0.0f};    // this thread's columns only
  float oacc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nd][e] = 0.0f;

  for (int j = 0; j < tiles; ++j) {
    const int k0 = j * BKV;
    if (j + 1 < tiles) {
      stage_kv((j + 1) & 1, k0 + BKV);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + (j & 1) * BKV * LD;
    const bf16* Vb = Vs + (j & 1) * BKV * LD;

    // S = Q K^T, 16 rows x BKV keys per warp
    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Kb + (16 * np + lane % 8 + 8 * (lane / 16)) * LD +
                            16 * ks + 8 * ((lane / 8) % 2));
        mma_bf16_16816(sacc[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16_16816(sacc[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // scores in units of log2 (s * scale * log2 e, so exp is one exp2);
    // only a tile that crosses the diagonal or the end of the keys is
    // masked
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] *= scale_log2;
    const bool edge =
        k0 + BKV > sk || (CAUSAL && k0 + BKV - 1 > q0 + 16 * warp);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * nt + 2 * t + (e & 1);
          const int row = qrow + 8 * (e >> 1);
          if (col >= sk || (CAUSAL && row < col)) sacc[nt][e] = NEG;
        }
      }
    }
    // the rows' max over the quad
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sacc[nt][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // p = exp(s - m), summed unrounded into l
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sacc[nt][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        sacc[nt][e] = p;
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nd][e] *= alpha[e >> 1];

    // O += T(P) V: two 8-key tiles of S are one A fragment
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vb + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) *
                                       LD +
                                  16 * dp + 8 * (lane / 16));
        mma_bf16_16816(oacc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16_16816(oacc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                // this buffer is refilled next tile
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = qrow + 8 * r;
    if (row >= s) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    bf16* orow = op + (int64_t)row * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      store2(&orow[8 * nd + 2 * t], oacc[nd][2 * r] / l,
             oacc[nd][2 * r + 1] / l);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, int sk, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::SMEM;
  auto kernel = causal ? flash_attention_mma_kernel<D, true>
                       : flash_attention_mma_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), hq, hkv, s, sk,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int b, int hq, int hkv, int s, int sk, float scale, int causal,
           cudaStream_t st) {
  if (dtype == DT_F32) {
    return ffma::launch<float, D>(q, k, v, o, b, hq, hkv, s, sk, scale,
                                  causal, st);
  }
  return tc::launch<D>(q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
}

}  // namespace

// q: (b, hq, s, d); k, v: (b, hkv, sk, d); o: like q; all contiguous and of
// one dtype (DT_F32 or DT_BF16), on 16-byte boundaries.  hq % hkv == 0; d
// one of 16, 64, 80, 112, 128, 256.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int hq, int hkv, int s,
                               int sk, int d, float scale, int causal,
                               int dtype, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || s < 1 || sk < 1 || hq % hkv != 0 ||
      b > 65535 || hq > 65535 || (dtype != DT_F32 && dtype != DT_BF16)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(dtype, q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    case 64: return launch<64>(dtype, q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    case 80: return launch<80>(dtype, q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    case 112: return launch<112>(dtype, q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    case 128: return launch<128>(dtype, q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    case 256: return launch<256>(dtype, q, k, v, o, b, hq, hkv, s, sk, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
