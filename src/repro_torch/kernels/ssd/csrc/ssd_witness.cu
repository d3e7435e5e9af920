// ssd: the Mamba2 state-space-duality chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py::ssd_pallas.  Per
// (batch, head) the sequence is cut into chunks of Q steps; inside a chunk
// (seg = cumsum(dta), total = seg[Q-1])
//   y_i  = sum_{j<=i} T(CB_ij * exp(seg_i - seg_j)) xdt_j
//          + exp(seg_i) * C_i . S_prev          (CB = C B^T, fp32 sums)
//   S    = exp(total) S_prev + sum_j (exp(total - seg_j) xdt_j)^T B_j
// with the (P x N) fp32 state S carried from chunk to chunk, as
// ssd.py:34-77 computes it: the decay is masked inside the exp (the upper
// triangle is exactly 0), the (Q x Q) tile CB * decay is rounded to xdt's
// type T before its product with xdt, every product accumulates in fp32,
// y is written in T and the final state in fp32.  B and C have no head
// index: every head of a batch row reads the same (L x N) rows.
//
// What bounds it on an H100: at zamba2's prefill (B 4, H 80, L 1024,
// P 64, N 64, Q 128) the model hands it fp32 (its conv weights are fp32):
// xdt and y are 84 MB each and the state 5 MB, 53 us at 3.35 TB/s, while
// the chunked products (~10.8 GFLOP) take 161 us at the CUDA cores' 67
// TFLOP/s, so the operations bound it (in bf16: 27 us by bytes).
//
// What the design does about it: this first version is simple and right.
// One 256-thread block owns one (batch, head) and walks its chunks in
// order, so the state stays in shared memory from the first chunk to the
// last and is written to device memory once.  Per chunk it stages xdt
// (Q x P) and B (Q x N) as fp32; the (Q x Q) tile is built in blocks of
// R = 32 rows, each with its 32 rows of C, so that at Q = 128 and N = 128
// (mamba2-130m) the staging takes 166 KB of the 227 KB a block may use
// (a whole fp32 Q x Q tile and all of C would not fit).  A row block only
// needs the columns up to its last row (the rest of the causal tile is 0),
// so it skips them.  Rows of B, C and S are stored with a stride of N + 1
// words, so the 32 rows a warp reads at one column fall in 32 banks.  The
// chunk's cumsum runs on one warp (four steps a lane, then a shuffle scan).
// Tensor cores, TMA and sharing CB across the heads of a batch row are
// later work.  The reduced configs' P = 16 and N = 16 (chunk 16) take the
// same kernel: y's columns tx + 32 c past P are idle lanes, and P N = 256
// state elements are one per thread.
//
// Interface: plain C, bound with ctypes.  The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the function returns
// the CUDA error of the launch so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The frozen witness of ssd.cu: the kernel as it stood before its
// redesign, bit for bit, kept to hold the redesigned kernel to.  The
// helpers it took from epilogue.cuh are inlined here, so that an edit of
// that shared header cannot move both kernels together.
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int THREADS = 256;
constexpr int R = 32;               // rows of the Q x Q tile built at once
constexpr int QMAX = 128;           // largest chunk

template <int P, int N>
size_t smem_bytes(int q) {
  const int nld = N + 1;
  return sizeof(float) *
         (size_t)(P * nld + q * P + q * nld + R * nld + R * q + 3 * q);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_witness_kernel(const T* __restrict__ xdt, const float* __restrict__ dta,
           const T* __restrict__ bm, const T* __restrict__ cm,
           T* __restrict__ y, float* __restrict__ state, int h, int l,
           int q) {
  constexpr int NLD = N + 1;
  constexpr int PC = (P + 31) / 32; // y columns per thread (P < 32: one)
  constexpr int SE = P * N / THREADS;   // state elements per thread
  static_assert((P % 32 == 0 || P < 32) && (P * N) % THREADS == 0,
                "tile shape");
  extern __shared__ float smem[];
  float* S = smem;                  // P x NLD, the carried state
  float* X = S + P * NLD;           // q x P, this chunk's xdt
  float* Bs = X + q * P;            // q x NLD, this chunk's B
  float* Cs = Bs + q * NLD;         // R x NLD, a row block of C
  float* G = Cs + R * NLD;          // R x q, a row block of T(CB * decay)
  float* seg = G + R * q;           // q: cumsum(dta)
  float* eseg = seg + q;            // q: exp(seg)
  float* wexp = eseg + q;           // q: exp(total - seg)

  const int tid = threadIdx.x;
  const int ty = tid / 32;          // rows 4 ty .. 4 ty + 3 of a row block
  const int tx = tid % 32;          // cols tx + 32 j
  // a y column this lane reads (an idle lane past P reads column 0 and
  // stores nothing)
  auto ycol = [&](int c) { return tx + 32 * c < P ? tx + 32 * c : 0; };
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t bh = (int64_t)b * h + hh;
  const T* xp = xdt + bh * l * P;
  const float* dp = dta + bh * l;
  const T* bp = bm + (int64_t)b * l * N;
  const T* cp = cm + (int64_t)b * l * N;
  T* yp = y + bh * l * P;

  for (int e = tid; e < P * N; e += THREADS) S[(e / N) * NLD + e % N] = 0.0f;

  for (int c0 = 0; c0 < l; c0 += q) {
    __syncthreads();                // the last chunk's state update is done
    for (int idx = tid; idx < q * P; idx += THREADS) {
      X[idx] = to_f32(xp[(int64_t)c0 * P + idx]);
    }
    for (int idx = tid; idx < q * N; idx += THREADS) {
      Bs[(idx / N) * NLD + idx % N] = to_f32(bp[(int64_t)c0 * N + idx]);
    }
    if (tid < 32) {                 // seg = cumsum(dta) over the chunk
      float v[4];
      float run = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 4 * tid + t;
        run += i < q ? dp[c0 + i] : 0.0f;
        v[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 4 * tid + t;
        if (i < q) seg[i] = excl + v[t];
      }
    }
    __syncthreads();
    const float total = seg[q - 1];
    for (int i = tid; i < q; i += THREADS) {
      eseg[i] = expf(seg[i]);
      wexp[i] = expf(total - seg[i]);
    }

    for (int r0 = 0; r0 < q; r0 += R) {
      __syncthreads();              // the last block's readers of Cs, G
      for (int idx = tid; idx < R * N; idx += THREADS) {
        const int r = idx / N, n = idx % N;
        Cs[r * NLD + n] =
            r0 + r < q ? to_f32(cp[(int64_t)(c0 + r0 + r) * N + n]) : 0.0f;
      }
      __syncthreads();

      // G = T(C_blk B^T * decay), columns j < jend (the rest are 0)
      const int jend = min(q, r0 + R);
      const int njj = (jend + 31) / 32;
      float g[4][QMAX / 32];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < QMAX / 32; ++jj) g[i][jj] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float ca[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = Cs[(4 * ty + i) * NLD + n];
#pragma unroll
        for (int jj = 0; jj < QMAX / 32; ++jj) {
          if (jj < njj) {
            const int j = min(tx + 32 * jj, q - 1);
            const float bv = Bs[j * NLD + n];
#pragma unroll
            for (int i = 0; i < 4; ++i) g[i][jj] = fmaf(ca[i], bv, g[i][jj]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = r0 + 4 * ty + i;
#pragma unroll
        for (int jj = 0; jj < QMAX / 32; ++jj) {
          const int j = tx + 32 * jj;
          if (j < jend) {
            G[(4 * ty + i) * q + j] =
                (gi < q && j <= gi)
                    ? round_as<T>(g[i][jj] * expf(seg[gi] - seg[j]))
                    : 0.0f;
          }
        }
      }
      __syncthreads();

      // y rows of this block: the intra-chunk product and the state term
      float ya[4][PC], yi[4][PC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < PC; ++c) ya[i][c] = yi[i][c] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < jend; ++j) {
        float ga[4], xv[PC];
#pragma unroll
        for (int i = 0; i < 4; ++i) ga[i] = G[(4 * ty + i) * q + j];
#pragma unroll
        for (int c = 0; c < PC; ++c) xv[c] = X[j * P + ycol(c)];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PC; ++c) ya[i][c] = fmaf(ga[i], xv[c], ya[i][c]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float ca[4], sv[PC];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = Cs[(4 * ty + i) * NLD + n];
#pragma unroll
        for (int c = 0; c < PC; ++c) sv[c] = S[ycol(c) * NLD + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < PC; ++c) yi[i][c] = fmaf(ca[i], sv[c], yi[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = r0 + 4 * ty + i;
        if (gi >= q) continue;
        T* yrow = yp + (int64_t)(c0 + gi) * P;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          if (tx + 32 * c < P) {
            store(&yrow[tx + 32 * c], ya[i][c] + eseg[gi] * yi[i][c]);
          }
        }
      }
    }
    __syncthreads();                // every row block has read S

    // S = exp(total) S + sum_j (exp(total - seg_j) xdt_j)^T B_j
    const float etot = expf(total);
#pragma unroll
    for (int u = 0; u < SE; ++u) {
      const int e = tid + u * THREADS;
      const int p = e / N, n = e % N;
      float acc = 0.0f;
      for (int j = 0; j < q; ++j) {
        const float w = wexp[j] * X[j * P + p];
        acc = fmaf(w, Bs[j * NLD + n], acc);
      }
      S[p * NLD + n] = etot * S[p * NLD + n] + acc;
    }
  }

  // each thread stores the state elements it updated last
  float* sp = state + bh * P * N;
#pragma unroll
  for (int u = 0; u < SE; ++u) {
    const int e = tid + u * THREADS;
    sp[e] = S[(e / N) * NLD + e % N];
  }
}

template <typename T, int P, int N>
int launch(const void* xdt, const void* dta, const void* bm, const void* cm,
           void* y, void* state, int b, int h, int l, int q,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<P, N>(q);
  auto kernel = ssd_witness_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xdt), static_cast<const float*>(dta),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), static_cast<float*>(state), h, l, q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int p, int n, const void* xdt, const void* dta, const void* bm,
             const void* cm, void* y, void* state, int b, int h, int l,
             int q, cudaStream_t st) {
  if (p == 16 && n == 16) {
    return launch<T, 16, 16>(xdt, dta, bm, cm, y, state, b, h, l, q, st);
  }
  if (p != 64) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 64: return launch<T, 64, 64>(xdt, dta, bm, cm, y, state, b, h, l, q, st);
    case 128: return launch<T, 64, 128>(xdt, dta, bm, cm, y, state, b, h, l, q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// xdt: (b, h, l, p) of dtype; dta: (b, h, l) fp32; bm, cm: (b, l, n) of
// dtype; y: like xdt; state: (b, h, p, n) fp32; all contiguous.  l is a
// multiple of the chunk q (1 <= q <= 128); (p, n) one of (64, 64),
// (64, 128), (16, 16).
extern "C" int ssd_witness(const void* xdt, const void* dta, const void* bm,
                   const void* cm, void* y, void* state, int b, int h, int l,
                   int p, int n, int q, int dtype, void* stream) {
  if (b < 1 || h < 1 || l < 1 || q < 1 || q > QMAX || l % q != 0 ||
      b > 65535 || (dtype != DT_F32 && dtype != DT_BF16)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    return launch_n<float>(p, n, xdt, dta, bm, cm, y, state, b, h, l, q, st);
  }
  return launch_n<__nv_bfloat16>(p, n, xdt, dta, bm, cm, y, state, b, h, l,
                                 q, st);
}
