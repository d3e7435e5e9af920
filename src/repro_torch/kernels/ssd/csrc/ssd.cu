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
// P 64, N 64, Q 128) the model hands it fp32 (its conv weights are fp32).
// xdt and y are 84 MB each, 50 us at 3.35 TB/s, while the chunked
// products take ~8.8 GFLOP, 0.13 ms at the CUDA cores' 67 TFLOP/s: the
// FFMA rate bounds it (in bf16: 25 us by bytes).  Its first version lost
// most of that rate in three places: one block per (batch, head) gave 320
// blocks of ~106 KB shared memory (two a SM, a second wave of 56 at
// prefill, 61 % of the places at the training shape's 160), C B^T was
// computed once per head though it has no head index, and its inner loops
// read one to three shared words per fmaf.
//
// What this design does about it:
// - ssd_cb_kernel computes the causal half of CB = C B^T once per (batch
//   row, chunk), each element the fmaf chain over n = 0 .. N-1 from 0.0f,
//   into a fp32 workspace of B (L/Q) Q^2 floats that the caller allocates.
// - ssd_kernel splits P into slabs of PS columns (no sum in SSD runs over
//   p): the grid is (P/PS x H, B), 640 blocks at prefill and 320 at the
//   training shape with PS = 32.  Each block walks its head's chunks in
//   order and keeps its (PS x N) slab of the state in registers.
// - Register blocking: warp w owns a row block of 16 rows of y and of the
//   decay tile G = T(CB * exp(seg_i - seg_j)), which it builds in place
//   over the CB rows staged for it (rows packed to the causal width, 36 KB
//   at Q = 128); a lane holds 4 x 4 (P = 16: 2 x 4) outputs of G xdt and
//   of C S^T, fed by 128-bit loads (8 loads per 64 fmaf).  The state
//   update multiplies w = exp(total - seg_j) xdt_j once per (j, p) and
//   holds a 2 x 4 (N = 128: 4 x 4) tile of the slab a thread.  Warps pair
//   a short row block with a long one on each scheduler.
// - Staging with cp.async: B goes in over C once y is done, the next
//   chunk's CB rows over G while the state updates, and its xdt slab and C
//   right after.  At N = 64 a block takes 94 KB, so two fit on an SM.
//
// The bits are the first version's (kept as ssd_witness.cu, which the card
// tests hold this kernel to with torch.equal): the same one-warp cumsum,
// the same exps, the same fmaf chains in the same order (G xdt over j,
// C S^T over n, the state update over j, all from 0.0f; the G xdt chain
// skips only products by the masked zeros), and the two contractions nvcc
// made there written as fmaf: y = fmaf(exp(seg_i), C S^T, G xdt) and
// S = fmaf(exp(total), S, sum).  No fast-math flag.  Tensor cores would
// change the bits (fp32 needs 3xTF32) and are later work.
//
// Widths: P in {4, 8, 16, 32, 64} x N in {16, 64, 128}.  P = 64 takes
// slabs of 32 columns; a smaller P one slab of all of it, which is what a
// rank of a mesh that splits P over 'model' gets (64 over 2, 4 and 16
// ranks; the reduced configs' 16 over 2 and 4).  No sum runs over p, and
// every tile keeps each element's chains, so a call on columns [p0, p1)
// gives the bits of those columns of the full-P call.  Where a slab is too
// narrow for the tiles, threads idle: at PS = 4 a warp's y tile is a row
// a lane on 16 lanes, and where PS N < 256 the state update runs on the
// first PS N threads.
//
// Interface: plain C, bound with ctypes.  The launches go on the caller's
// stream, allocate nothing and do not synchronise; the function returns
// the first CUDA error so that a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "ptx.cuh"

namespace {

using namespace synergy;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QMAX = 128;           // largest chunk
constexpr int RB = 16;              // rows of y and G a warp owns
constexpr int CBT = 32;             // ssd_cb_kernel's tile: CBT x CBT of CB
static_assert(RB * WARPS == QMAX, "one row block per warp");


// G packed by row blocks: row block r holds its RB rows at the causal
// width RB (r + 1), from float g_base(r) on
__host__ __device__ constexpr int g_base(int r) {
  return RB * RB * r * (r + 1) / 2;
}
constexpr int G_FLOATS = g_base(QMAX / RB);

template <int P, int N, int PS>
constexpr size_t smem_floats() {
  return G_FLOATS + QMAX * PS + QMAX * N + N * PS + 3 * QMAX;
}

// ------------------------------------------------------------- helpers

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// four neighbouring elements of a row, p aligned to four: one vector store
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// rows x cols of a row-major source (row stride lds elements) into fp32
// shared rows of stride ldd, by the threads tid0, tid0 + nthr, ...: fp32
// by cp.async, 16 bytes a copy when cols, lds and the source are aligned
// to four, else 4; bf16 by plain loads converted to fp32
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src,
                                      int64_t lds, int rows, int cols,
                                      int tid0, int nthr) {
  if ((cols & 3) == 0 && (lds & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int c4 = cols / 4;
    for (int v = tid0; v < rows * c4; v += nthr) {
      const int r = v / c4, c = 4 * (v % c4);
      cp_async16(dst + r * ldd + c, src + r * lds + c, 16);
    }
  } else {
    for (int v = tid0; v < rows * cols; v += nthr) {
      const int r = v / cols, c = v % cols;
      cp_async4(dst + r * ldd + c, src + r * lds + c, 4);
    }
  }
}
__device__ __forceinline__ void stage(float* dst, int ldd,
                                      const __nv_bfloat16* src, int64_t lds,
                                      int rows, int cols, int tid0,
                                      int nthr) {
  // cols and lds are multiples of four (P, N and the slab width are)
  const int c4 = cols / 4;
  for (int v = tid0; v < rows * c4; v += nthr) {
    const int r = v / c4, c = 4 * (v % c4);
    const __nv_bfloat162* s =
        reinterpret_cast<const __nv_bfloat162*>(src + r * lds + c);
    const float2 a = __bfloat1622float2(s[0]);
    const float2 b = __bfloat1622float2(s[1]);
    *reinterpret_cast<float4*>(dst + r * ldd + c) =
        make_float4(a.x, a.y, b.x, b.y);
  }
}

// ----------------------------------------------- CB = C B^T, once per chunk

// grid (tiles x chunks, B): tile (ti, tj), tj <= ti, of the causal half of
// a chunk's CB; each thread 4 rows x 1 column, the witness's chain
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
              float* __restrict__ cbw, int l, int q) {
  constexpr int NLD = N + 1;
  __shared__ float Cs[CBT * NLD];
  __shared__ float Bs[CBT * NLD];
  const int nt = (q + CBT - 1) / CBT;
  const int tiles = nt * (nt + 1) / 2;
  const int c = blockIdx.x / tiles;
  int k = blockIdx.x % tiles, ti = 0;
  while (k > ti) k -= ++ti;
  const int tj = k;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int i0 = CBT * ti, j0 = CBT * tj;
  const int64_t row0 = (int64_t)b * l + (int64_t)c * q;
  for (int idx = tid; idx < CBT * N; idx += THREADS) {
    const int r = idx / N, n = idx % N;
    Cs[r * NLD + n] = i0 + r < q ? to_f32(cm[(row0 + i0 + r) * N + n]) : 0.0f;
    Bs[r * NLD + n] = j0 + r < q ? to_f32(bm[(row0 + j0 + r) * N + n]) : 0.0f;
  }
  __syncthreads();
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    const float bv = Bs[tx * NLD + n];
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = fmaf(Cs[(4 * ty + i) * NLD + n], bv, g[i]);
  }
  float* out = cbw + row0 * q;    // chunk (b, c) starts at row b l + c q
  const int j = j0 + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + 4 * ty + i;
    if (gi < q && j <= gi) out[(int64_t)gi * q + j] = g[i];
  }
}

// ------------------------------------------------------- the chunked scan

template <typename T, int P, int N, int PS>
__global__ void __launch_bounds__(THREADS, 2)
ssd_kernel(const T* __restrict__ xdt, const float* __restrict__ dta,
           const T* __restrict__ bm, const T* __restrict__ cm,
           const float* __restrict__ cbw, T* __restrict__ y,
           float* __restrict__ state, int h, int l, int q) {
  // y: a warp's RB rows x PS columns, YI rows x 4 columns a lane, on
  // its first YL lanes (16 at PS = 4: a row a lane; the rest idle)
  constexpr int YPG = PS / 4;
  constexpr int YI = RB * YPG >= 32 ? RB * YPG / 32 : 1;
  constexpr int YL = RB * YPG / YI;
  // the state update: SP p x SN n a thread, p fastest across threads, on
  // the first ST threads (all of them unless PS N < THREADS)
  constexpr int SN = PS * N >= 4 * THREADS ? 4 : 1;
  constexpr int SP = PS * N >= THREADS ? PS * N / (THREADS * SN) : 1;
  constexpr int ST = PS * N / (SP * SN);
  constexpr int PG = PS / SP;
  static_assert(P % PS == 0 && PS % 4 == 0 && N % 4 == 0 && YL <= 32 &&
                    YI * YL == RB * YPG && SP >= 1 && ST <= THREADS &&
                    SP * SN * ST == PS * N && PG * (N / SN) == ST,
                "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* G = smem;                  // packed rows: CB, then T(CB * decay)
  float* X = G + G_FLOATS;          // q x PS: xdt's slab, then w
  float* CBs = X + QMAX * PS;       // q x N: C, then B
  float* Ss = CBs + QMAX * N;       // N x PS: the state before the chunk
  float* seg = Ss + N * PS;         // q: cumsum(dta)
  float* eseg = seg + QMAX;         // q: exp(seg)
  float* wexp = eseg + QMAX;        // q: exp(total - seg)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int NS = P / PS;
  const int p0 = PS * (blockIdx.x % NS);
  const int hh = blockIdx.x / NS;
  const int b = blockIdx.y;
  const int64_t bh = (int64_t)b * h + hh;
  const int nc = l / q;
  const T* xp = xdt + bh * l * P + p0;
  const float* dp = dta + bh * l;
  const T* bp = bm + (int64_t)b * l * N;
  const T* cp = cm + (int64_t)b * l * N;
  const float* cbp = cbw + (int64_t)b * l * q;
  T* yp = y + bh * l * P + p0;

  // this warp's row block: warps w and w + 4 (one scheduler) take a short
  // and a long one
  const int rb = warp < WARPS / 2 ? warp : 3 * WARPS / 2 - 1 - warp;
  const int r0 = RB * rb;
  const int wg = RB * (rb + 1);     // its causal width
  float* Gw = G + g_base(rb);
  const int yr = (lane / YPG) * YI; // first row (in the block) of a lane
  const int yc = (lane % YPG) * 4;  // first column of a lane
  const int sp = (tid % PG) * SP;   // first p of the state tile
  const int sn = (tid / PG) * SN;   // first n of the state tile

  // CB's rows of this warp's row block (causal width) into G, C into CBs,
  // the xdt slab into X
  auto stage_cb = [&](int c) {
    if (r0 < q) {
      stage(Gw, wg, cbp + ((int64_t)c * q + r0) * q, q, min(RB, q - r0),
            min(wg, q), lane, 32);
    }
  };
  auto stage_xc = [&](int c) {
    stage(X, PS, xp + (int64_t)c * q * P, P, q, PS, tid, THREADS);
    stage(CBs, N, cp + (int64_t)c * q * N, N, q, N, tid, THREADS);
  };

  float s[SP][SN];
#pragma unroll
  for (int a = 0; a < SP; ++a)
#pragma unroll
    for (int e = 0; e < SN; ++e) s[a][e] = 0.0f;
  for (int e = tid; e < N * PS; e += THREADS) Ss[e] = 0.0f;
  stage_cb(0);
  stage_xc(0);
  cp_async_commit();

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * q;
    cp_async_wait<0>();
    __syncthreads();                // X, C, CB staged; Ss is S_prev
    if (warp == 0) {                // seg = cumsum(dta), as the witness
      float v[4];
      float run = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 4 * lane + t;
        run += i < q ? dp[c0 + i] : 0.0f;
        v[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 4 * lane + t;
        if (i < q) seg[i] = excl + v[t];
      }
    }
    __syncthreads();
    const float total = seg[q - 1];
    for (int i = tid; i < q; i += THREADS) {
      eseg[i] = expf(seg[i]);
      wexp[i] = expf(total - seg[i]);
    }
    // G = T(CB * decay) in place, 0 above the diagonal and past q
    if (r0 < q) {
      for (int e = lane; e < RB * wg; e += 32) {
        const int i = r0 + e / wg, j = e % wg;
        float g = 0.0f;
        if (i < q && j <= i) g = round_as<T>(Gw[e] * expf(seg[i] - seg[j]));
        Gw[e] = g;
      }
    }
    __syncthreads();                // eseg; G (each warp reads its own)

    if (r0 < q && lane < YL) {
      // ya = G xdt over j (the masked zeros past the row are skipped up
      // to the row block's width), yi = C S_prev^T over n
      float ya[YI][4], yi[YI][4];
#pragma unroll
      for (int a = 0; a < YI; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[a][e] = yi[a][e] = 0.0f;
      const float* grow = Gw + yr * wg;
      const int jend = min(q, wg);
      int j = 0;
#pragma unroll 2
      for (; j + 4 <= jend; j += 4) {
        float4 gv[YI], xv[4];
#pragma unroll
        for (int a = 0; a < YI; ++a) gv[a] = lds4(grow + a * wg + j);
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = lds4(X + (j + k) * PS + yc);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int a = 0; a < YI; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ya[a][e] = fmaf(at(gv[a], k), at(xv[k], e), ya[a][e]);
      }
      for (; j < jend; ++j) {
        const float4 xv = lds4(X + j * PS + yc);
#pragma unroll
        for (int a = 0; a < YI; ++a) {
          const float gv = grow[a * wg + j];
#pragma unroll
          for (int e = 0; e < 4; ++e) ya[a][e] = fmaf(gv, at(xv, e), ya[a][e]);
        }
      }
      const float* crow = CBs + (r0 + yr) * N;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[YI], sv[4];
#pragma unroll
        for (int a = 0; a < YI; ++a) cv[a] = lds4(crow + a * N + n);
#pragma unroll
        for (int k = 0; k < 4; ++k) sv[k] = lds4(Ss + (n + k) * PS + yc);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int a = 0; a < YI; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              yi[a][e] = fmaf(at(cv[a], k), at(sv[k], e), yi[a][e]);
      }
#pragma unroll
      for (int a = 0; a < YI; ++a) {
        const int i = r0 + yr + a;
        if (i >= q) continue;
        const float es = eseg[i];
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fmaf(es, yi[a][e], ya[a][e]);
        store4(yp + (int64_t)(c0 + i) * P + yc, v);
      }
    }
    __syncthreads();                // G, C and X read

    // B over C; the next chunk's CB over G, while w and the state update
    // run
    stage(CBs, N, bp + (int64_t)c0 * N, N, q, N, tid, THREADS);
    cp_async_commit();
    if (c + 1 < nc) stage_cb(c + 1);
    cp_async_commit();
    for (int e = tid; e < q * PS; e += THREADS) X[e] = wexp[e / PS] * X[e];
    cp_async_wait<1>();
    __syncthreads();                // w and B

    // S = exp(total) S + sum_j w_j^T B_j, the slab tile in registers
    if (tid < ST) {
      const float etot = expf(total);
      float acc[SP][SN];
#pragma unroll
      for (int a = 0; a < SP; ++a)
#pragma unroll
        for (int e = 0; e < SN; ++e) acc[a][e] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < q; ++j) {
        float wv[SP], bv[SN];
#pragma unroll
        for (int a = 0; a < SP; ++a) wv[a] = X[j * PS + sp + a];
#pragma unroll
        for (int e = 0; e < SN; ++e) bv[e] = CBs[j * N + sn + e];
#pragma unroll
        for (int a = 0; a < SP; ++a)
#pragma unroll
          for (int e = 0; e < SN; ++e)
            acc[a][e] = fmaf(wv[a], bv[e], acc[a][e]);
      }
#pragma unroll
      for (int a = 0; a < SP; ++a)
#pragma unroll
        for (int e = 0; e < SN; ++e) s[a][e] = fmaf(etot, s[a][e], acc[a][e]);
    }
    __syncthreads();                // w and B read
    if (tid < ST) {
#pragma unroll
      for (int a = 0; a < SP; ++a)
#pragma unroll
        for (int e = 0; e < SN; ++e) Ss[(sn + e) * PS + sp + a] = s[a][e];
    }
    if (c + 1 < nc) stage_xc(c + 1);
    cp_async_commit();
  }

  if (tid < ST) {
    float* stp = state + (bh * P + p0) * N;
#pragma unroll
    for (int a = 0; a < SP; ++a)
#pragma unroll
      for (int e = 0; e < SN; ++e) stp[(sp + a) * N + sn + e] = s[a][e];
  }
}

template <typename T, int P, int N>
int launch(const void* xdt, const void* dta, const void* bm, const void* cm,
           void* y, void* state, void* cbw, int b, int h, int l, int q,
           cudaStream_t stream) {
  // a P-slab of 32 columns at P = 64 (16 took 1.6x as long at prefill:
  // scripts/ssd_probe.py --variants slab16), all of P below
  constexpr int PS = P > 32 ? 32 : P;
  const int nt = (q + CBT - 1) / CBT;
  const dim3 cb_grid(nt * (nt + 1) / 2 * (l / q), b);
  ssd_cb_kernel<T, N><<<cb_grid, THREADS, 0, stream>>>(
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<float*>(cbw), l, q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * smem_floats<P, N, PS>();
  auto kernel = ssd_kernel<T, P, N, PS>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P / PS) * h, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xdt), static_cast<const float*>(dta),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(cbw), static_cast<T*>(y),
      static_cast<float*>(state), h, l, q);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_p(int n, const void* xdt, const void* dta, const void* bm,
             const void* cm, void* y, void* state, void* cbw, int b, int h,
             int l, int q, cudaStream_t st) {
  switch (n) {
    case 16:
      return launch<T, P, 16>(xdt, dta, bm, cm, y, state, cbw, b, h, l, q, st);
    case 64:
      return launch<T, P, 64>(xdt, dta, bm, cm, y, state, cbw, b, h, l, q, st);
    case 128:
      return launch<T, P, 128>(xdt, dta, bm, cm, y, state, cbw, b, h, l, q,
                               st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_n(int p, int n, const void* xdt, const void* dta, const void* bm,
             const void* cm, void* y, void* state, void* cbw, int b, int h,
             int l, int q, cudaStream_t st) {
  switch (p) {
    case 4:
      return launch_p<T, 4>(n, xdt, dta, bm, cm, y, state, cbw, b, h, l, q, st);
    case 8:
      return launch_p<T, 8>(n, xdt, dta, bm, cm, y, state, cbw, b, h, l, q, st);
    case 16:
      return launch_p<T, 16>(n, xdt, dta, bm, cm, y, state, cbw, b, h, l, q,
                             st);
    case 32:
      return launch_p<T, 32>(n, xdt, dta, bm, cm, y, state, cbw, b, h, l, q,
                             st);
    case 64:
      return launch_p<T, 64>(n, xdt, dta, bm, cm, y, state, cbw, b, h, l, q,
                             st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// xdt: (b, h, l, p) of dtype; dta: (b, h, l) fp32; bm, cm: (b, l, n) of
// dtype; y: like xdt; state: (b, h, p, n) fp32; cbw: the fp32 workspace of
// b (l / q) q^2 floats for C B^T; all contiguous.  l is a multiple of the
// chunk q (1 <= q <= 128); p one of 4, 8, 16, 32, 64 and n one of 16,
// 64, 128.
extern "C" int ssd(const void* xdt, const void* dta, const void* bm,
                   const void* cm, void* y, void* state, void* cbw, int b,
                   int h, int l, int p, int n, int q, int dtype,
                   void* stream) {
  if (b < 1 || h < 1 || l < 1 || q < 1 || q > QMAX || l % q != 0 ||
      b > 65535 || (int64_t)h * (p > 32 ? p / 32 : 1) > 0x7fffffff ||
      (dtype != DT_F32 && dtype != DT_BF16)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    return launch_n<float>(p, n, xdt, dta, bm, cm, y, state, cbw, b, h, l, q,
                           st);
  }
  return launch_n<__nv_bfloat16>(p, n, xdt, dta, bm, cm, y, state, cbw, b, h,
                                 l, q, st);
}
