// qmm: C[m, n] = act((A_q[m, k] @ W_q[k, n]) * scale[n] + bias[n]) with int8
// operands and an exact int32 accumulator, for Hopper (sm_90a), on the int8
// tensor cores.
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
// The runtime's 32-row panels are far below both bounds: there the time is
// the latency of one block's walk over k.
//
// What the design does about it:
// - The products run on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32
//   (IMMA), int32 accumulators in registers, fragments by ldmatrix.  A
//   block owns a 128 x 64 tile (n <= 128) or 128 x 128, eight warps of 32
//   x 32 or 64 x 32, k steps of 64 through a three-stage ring; where those
//   tiles would not reach half the SMs (the runtime's 32-row panels, the
//   FC layers) a 32 x 32 tile of two warps and a four-stage ring.  Integer
//   sums are exact in any order, so the tile, the path and the k order
//   change no bit, and the tile may follow m.
// - Both operands must be k-major for IMMA (the B fragment is ".col", and
//   ldmatrix moves 16-bit elements, so it cannot transpose bytes).  A is
//   row-major (m, k): k-major already.  W is row-major (k, n): it lands in
//   shared memory as it lies (n-major) and is transposed there in 4 x 4
//   byte blocks through __byte_perm, never in device memory.
// - Every load is a cp.async into the ring, so the next k steps load while
//   this one multiplies.  Path "async" (k and n multiples of 16, A and W on
//   16-byte boundaries: conv2, conv4, fc6 and their panels) copies 16-byte
//   chunks; A's copies ask the L2 for whole 128-byte lines, since a block
//   reads each row of A 64 bytes a step and the next step's bytes then
//   wait in L2.  Path "shift" (any other shape or address: conv0's k = 75,
//   whose rows and row panels start at any byte, and fc7's n = 10) copies
//   the aligned 4-byte words that hold each row's bytes, and a funnel shift
//   realigns every row in shared memory before the products.  Forced on
//   the aligned shapes, shift takes 2-4 times async's device time
//   (scripts/qmm_path_probe.py), so async stays.
// - Rows of A past m and rows of W past k are staged as zeros, so the
//   neighbouring bytes that an aligned word brings along meet zeros or land
//   in outputs that are never stored.  Such a word is read only if it holds
//   a byte of the operand; CUDA allocations start on 256-byte boundaries
//   and PyTorch's span whole 512-byte blocks, so the word never leaves the
//   operand's allocation.  -128 is accepted in either operand.
// - Each thread's accumulator fragment holds two neighbouring columns, so
//   the epilogue stores them as one 8-byte (fp32, int32) or 4-byte (bf16)
//   word when n is even: a quad of threads writes one 32-byte sector.
//
// The epilogue's rounding is spelled out: with a bias, fmaf(float(acc),
// scale, bias) rounds once (as repro's XLA-contracted epilogue does);
// without one, __fmul_rn(float(acc), scale).  Nothing is left to nvcc's
// contraction.  The scale and bias are device pointers read at run time,
// so a new activation scale never rebuilds the kernel.
//
// Interface: plain C, bound with ctypes.  The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the function returns
// the CUDA error of the launch so that a refused launch is reported.
// qmm_path() says which path a call with these operands takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "launch.cuh"
#include "ptx.cuh"

namespace {

using namespace synergy;

constexpr int DT_I32 = 2;           // raw int32 accumulator, no epilogue
enum Path { PATH_ASYNC = 0, PATH_SHIFT = 1 };

int choose_path(const void* a, const void* w, int n, int k) {
  const bool aligned = k % 16 == 0 && n % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return aligned ? PATH_ASYNC : PATH_SHIFT;
}

// A BM x BN block tile of WM x WN warps, each warp MI x NI mma tiles of
// 16 x 8, k steps of BK bytes (a multiple of 32: one m16n8k32 product per
// 32) through a ring of STAGES buffers.
// Shared memory: the ring (each stage: A as copied, BM rows of LDK bytes,
// and W as copied, BK rows of LDW bytes), W k-major (BN rows of LDK bytes)
// and, on the shift path, A realigned (BM rows of LDK bytes).
template <int BM_, int BN_, int WM_, int WN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_;
  static constexpr int STAGES = STAGES_;
  // row stride of the k-major buffers: BK + 16 bytes puts the 8 rows that
  // one ldmatrix reads in 8 different bank quads (BK = 64 or 128)
  static constexpr int LDK = BK + 16;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = BM / WM / 16;
  static constexpr int NI = BN / WN / 8;
  static constexpr int LDW = BN + 16;       // a row as copied: BN + 4 bytes
  static constexpr int A_BYTES = BM * LDK;
  static constexpr int W_BYTES = BK * LDW;
  static constexpr int B_BYTES = BN * LDK;
  static constexpr size_t smem(int path) {
    return (size_t)STAGES * (A_BYTES + W_BYTES) + B_BYTES +
           (path == PATH_SHIFT ? A_BYTES : 0);
  }
  static_assert(NI % 2 == 0, "B fragments are loaded two n8 tiles at once");
  // the realigning and transposing loops hand each thread as many words
  static_assert((BM * BK / 16) % THREADS == 0 &&
                    (BK * BN / 16) % THREADS == 0 &&
                    (BM * BK / 4) % THREADS == 0,
                "staging loops must divide evenly");
};

using Wide = Tile<128, 128, 2, 4, 64, 3>;   // 256 threads, warps 64 x 32
using Narrow = Tile<128, 64, 4, 2, 64, 3>;  // 256 threads, warps 32 x 32
using Small = Tile<32, 32, 1, 2, 64, 4>;    // 64 threads, warps 32 x 16

// act(float(acc) * s + b), rounded as the header says
template <int ACT>
__device__ __forceinline__ float dequant(int acc, float s, float b,
                                         bool has_bias) {
  const float x = __int2float_rn(acc);
  return activate<ACT>(has_bias ? fmaf(x, s, b) : __fmul_rn(x, s));
}

// RAW: store the int32 sum.  Otherwise act(sum * scale + bias) in TOut.
// The grid is one-dimensional, column blocks fastest, so the blocks that
// share rows of A run together and read them from L2.
template <typename T, int PATH, typename TOut, int ACT, bool RAW>
__global__ void __launch_bounds__(T::THREADS)
qmm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ bias,
           TOut* __restrict__ c, int m, int n, int k) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, LDK = T::LDK;
  constexpr int THREADS = T::THREADS, STAGES = T::STAGES;
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ __align__(16) uint8_t qmm_smem[];
  uint8_t* Ar = qmm_smem;                    // STAGES x BM x LDK
  uint8_t* Wr = Ar + STAGES * T::A_BYTES;    // STAGES x BK x LDW
  uint8_t* Bt = Wr + STAGES * T::W_BYTES;    // BN x LDK
  uint8_t* Ap = Bt + T::B_BYTES;             // BM x LDK (shift path)

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp / T::WN) * (BM / T::WM);   // the warp's tile
  const int wcol = (warp % T::WN) * (BN / T::WN);
  const int nblocks = (n + BN - 1) / BN;
  const int64_t row0 = (int64_t)(blockIdx.x / nblocks) * BM;
  const int col0 = (int)(blockIdx.x % nblocks) * BN;
  const int steps = (k + BK - 1) / BK;
  const uintptr_t abase = reinterpret_cast<uintptr_t>(a);
  const uintptr_t wbase = reinterpret_cast<uintptr_t>(w);

  // k step `st` into its ring slot (nothing past the last step: an empty
  // group keeps the count of groups in flight).  Rows of A past m and rows
  // of W past k arrive as zeros.
  auto stage = [&](int st) {
    if (st < steps) {
      const int k0 = st * BK;
      uint8_t* ar = Ar + (st % STAGES) * T::A_BYTES;
      uint8_t* wr = Wr + (st % STAGES) * T::W_BYTES;
      if constexpr (PATH == PATH_ASYNC) {
        // k % 16 == 0 and n % 16 == 0: a 16-byte chunk is wholly in or out
        constexpr int ACH = BK / 16;
#pragma unroll
        for (int l = 0; l < BM * ACH / THREADS; ++l) {
          const int idx = tid + l * THREADS;
          const int r = idx / ACH, ch = idx % ACH;
          const bool in = row0 + r < m && k0 + 16 * ch < k;
          cp_async16_line(ar + r * LDK + 16 * ch,
                          in ? a + (row0 + r) * k + k0 + 16 * ch : a,
                          in ? 16 : 0);
        }
        constexpr int WCH = BN / 16;
#pragma unroll
        for (int l = 0; l < BK * WCH / THREADS; ++l) {
          const int idx = tid + l * THREADS;
          const int kk = idx / WCH, ch = idx % WCH;
          const bool in = k0 + kk < k && col0 + 16 * ch < n;
          cp_async16(wr + kk * T::LDW + 16 * ch,
                     in ? w + (int64_t)(k0 + kk) * n + col0 + 16 * ch : w,
                     in ? 16 : 0);
        }
      } else {
        // Row r of A is bytes [p, p + BK), p = a + (row0 + r) k + k0, at
        // any address: copy the BK / 4 + 1 aligned words from the one that
        // holds p, each only if it holds a byte of the row.  Bytes past k
        // that come along meet W's zero rows; bytes before p are shifted
        // out by realign().  W's rows likewise, from col0.
        constexpr int AW = BK / 4 + 1, WW = BN / 4 + 1;
        for (int idx = tid; idx < BM * AW; idx += THREADS) {
          const int r = idx / AW, j = idx % AW;
          const int64_t row = row0 + r;
          const uintptr_t src =
              ((abase + row * k + k0) & ~(uintptr_t)3) + 4 * j;
          const bool in = row < m && src < abase + row * k + k;
          cp_async4(ar + r * LDK + 4 * j,
                    in ? reinterpret_cast<const void*>(src) : a, in ? 4 : 0);
        }
        for (int idx = tid; idx < BK * WW; idx += THREADS) {
          const int kk = idx / WW, j = idx % WW;
          const int64_t krow = k0 + kk;
          const uintptr_t src =
              ((wbase + krow * n + col0) & ~(uintptr_t)3) + 4 * j;
          const bool in = krow < k && src < wbase + krow * n + n;
          cp_async4(wr + kk * T::LDW + 4 * j,
                    in ? reinterpret_cast<const void*>(src) : w, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // W of step st into its k-major buffer, one 4 (k) x 4 (n) byte block per
  // thread and pass; on the shift path each row is first shifted by the
  // offset of its first byte in its word
  auto transpose = [&](int st) {
    const uint8_t* wr = Wr + (st % STAGES) * T::W_BYTES;
    const int64_t k0 = (int64_t)st * BK;
    constexpr int NB = BN / 4;
#pragma unroll
    for (int l = 0; l < (BK / 4) * NB / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int nb = idx % NB, kb = idx / NB;
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = 4 * kb + i;
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(wr + kk * T::LDW) + nb;
        if constexpr (PATH == PATH_ASYNC) {
          r[i] = src[0];
        } else {
          const int sh = (int)((wbase + (k0 + kk) * n + col0) & 3);
          r[i] = __funnelshift_r(src[0], src[1], 8 * sh);
        }
      }
      // r[i] holds k 4kb+i at n 4nb..4nb+3; column j gathers byte j of each
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      uint8_t* dst = Bt + (4 * nb) * LDK + 4 * kb;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + LDK) = __byte_perm(t0, t2, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * LDK) = __byte_perm(t1, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * LDK) = __byte_perm(t1, t3, 0x7632);
    }
  };

  // shift path: A of step st realigned, so that byte kk of a row is k0 + kk
  auto realign = [&](int st) {
    const uint8_t* ar = Ar + (st % STAGES) * T::A_BYTES;
    const int64_t k0 = (int64_t)st * BK;
    constexpr int KW = BK / 4;
#pragma unroll
    for (int l = 0; l < BM * KW / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / KW, kw = idx % KW;
      const int sh = (int)((abase + (row0 + r) * k + k0) & 3);
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(ar + r * LDK) + kw;
      *reinterpret_cast<uint32_t*>(Ap + r * LDK + 4 * kw) =
          __funnelshift_r(src[0], src[1], 8 * sh);
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) stage(st);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();    // step st has landed
    __syncthreads();                // and step st - 1 is done with
    stage(st + STAGES - 1);
    transpose(st);
    if constexpr (PATH == PATH_SHIFT) realign(st);
    __syncthreads();
    const uint8_t* as =
        PATH == PATH_SHIFT ? Ap : Ar + (st % STAGES) * T::A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        // matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31) -> a0, a1, a2, a3
        ldmatrix_x4(af[i], as + (wrow + 16 * i + lane % 16) * LDK + ks +
                               16 * (lane / 16));
      }
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        // matrices (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15),
        // (n 8-15, k 16-31) -> b0, b1 of tile j and of tile j + 1
        const int n8 = wcol + 8 * j + (lane & 7) + 8 * (lane >> 4);
        uint32_t r[4];
        ldmatrix_x4(r, Bt + n8 * LDK + ks + 16 * ((lane >> 3) & 1));
        bf[j][0] = r[0], bf[j][1] = r[1], bf[j + 1][0] = r[2],
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8_16832(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

  // acc[i][j]: rows wrow + 16 i + g (e 0, 1) and + 8 (e 2, 3), columns
  // wcol + 8 j + 2 t (e even) and + 1 (e odd)
  const bool pairs = n % 2 == 0;     // then a pair is aligned to 2 elements
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int gc = col0 + wcol + 8 * j + 2 * t;
    if (gc >= n) continue;
    const bool two = gc + 1 < n;
    float s0 = 0.0f, s1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
    if constexpr (!RAW) {
      s0 = scale[gc];
      b0 = bias_at(bias, gc);
      if (two) {
        s1 = scale[gc + 1];
        b1 = bias_at(bias, gc + 1);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t gr = row0 + wrow + 16 * i + g + 8 * h;
        if (gr >= m) continue;
        TOut* p = c + gr * n + gc;
        const int v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (RAW) {
          if (pairs) {
            store2(p, v0, v1);
          } else {
            p[0] = v0;
            if (two) p[1] = v1;
          }
        } else {
          const bool has_bias = bias != nullptr;
          const float y0 = dequant<ACT>(v0, s0, b0, has_bias);
          const float y1 = dequant<ACT>(v1, s1, b1, has_bias);
          if (pairs) {
            store2(p, y0, y1);
          } else {
            store(p, y0);
            if (two) store(p + 1, y1);
          }
        }
      }
    }
  }
}

template <typename T, int PATH, typename TOut, int ACT, bool RAW>
int launch_tile(const int8_t* a, const int8_t* w, const float* scale,
                const float* bias, TOut* c, int m, int n, int k,
                cudaStream_t s) {
  auto kernel = qmm_kernel<T, PATH, TOut, ACT, RAW>;
  const size_t smem = T::smem(PATH);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)((m + T::BM - 1) / T::BM) * ((n + T::BN - 1) / T::BN);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, T::THREADS, smem, s>>>(a, w, scale, bias, c, m,
                                                    n, k);
  return (int)cudaSuccess;
}

// The tile never changes a bit (integer sums are exact), so it follows the
// shape: 128-row tiles while their grid reaches half the SMs, else Small;
// 64 columns up to n = 128 (conv4: two blocks on an SM beat one block of
// 128 x 128, whose walk over k is latency-bound), 128 beyond.
template <int PATH, typename TOut, int ACT, bool RAW>
int launch_path(const void* a, const void* w, const void* scale,
                const void* bias, void* c, int m, int n, int k,
                cudaStream_t s) {
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* w8 = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* cc = static_cast<TOut*>(c);
  const int bn = n <= 128 ? Narrow::BN : Wide::BN;
  const int64_t big = (int64_t)((m + 127) / 128) * ((n + bn - 1) / bn);
  if (2 * big < sm_count()) {
    return launch_tile<Small, PATH, TOut, ACT, RAW>(a8, w8, sc, bi, cc, m, n,
                                                    k, s);
  }
  if (n <= 128) {
    return launch_tile<Narrow, PATH, TOut, ACT, RAW>(a8, w8, sc, bi, cc, m,
                                                     n, k, s);
  }
  return launch_tile<Wide, PATH, TOut, ACT, RAW>(a8, w8, sc, bi, cc, m, n, k,
                                                 s);
}

template <typename TOut, int ACT, bool RAW>
int launch(const void* a, const void* w, const void* scale, const void* bias,
           void* c, int m, int n, int k, cudaStream_t s) {
  if (choose_path(a, w, n, k) == PATH_ASYNC) {
    return launch_path<PATH_ASYNC, TOut, ACT, RAW>(a, w, scale, bias, c, m,
                                                   n, k, s);
  }
  return launch_path<PATH_SHIFT, TOut, ACT, RAW>(a, w, scale, bias, c, m, n,
                                                 k, s);
}

template <typename TOut>
int launch_act(int act, const void* a, const void* w, const void* scale,
               const void* bias, void* c, int m, int n, int k,
               cudaStream_t s) {
  switch (act) {
    case ACT_RELU:
      return launch<TOut, ACT_RELU, false>(a, w, scale, bias, c, m, n, k, s);
    case ACT_SILU:
      return launch<TOut, ACT_SILU, false>(a, w, scale, bias, c, m, n, k, s);
    default:
      return launch<TOut, ACT_NONE, false>(a, w, scale, bias, c, m, n, k, s);
  }
}

}  // namespace

// Which path qmm() takes for these operands: 0 async (k % 16 == 0,
// n % 16 == 0, a and w on 16-byte boundaries), 1 shift.  m plays no part.
extern "C" int qmm_path(const void* a, const void* w, int n, int k) {
  return choose_path(a, w, n, k);
}

// a, w: row-major int8 (m, k) and (k, n); scale: fp32 (n,), the dequant
// multiplier (w_scale * act_scale), unread in raw mode; bias: fp32 (n,) or
// null; c: row-major (m, n) of out_dtype (DT_F32, DT_BF16, or DT_I32 for
// the raw accumulator, which ignores scale, bias and act), on a boundary of
// 8 bytes.  m, n >= 1, k >= 0.
extern "C" int qmm(const void* a, const void* w, const void* scale,
                   const void* bias, void* c, int m, int n, int k,
                   int out_dtype, int act, void* stream) {
  if (m < 1 || n < 1 || k < 0 || act < ACT_NONE || act > ACT_SILU ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16 && out_dtype != DT_I32) ||
      (out_dtype != DT_I32 && scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (out_dtype == DT_I32) {
    rc = launch<int32_t, ACT_NONE, true>(a, w, scale, bias, c, m, n, k, s);
  } else if (out_dtype == DT_F32) {
    rc = launch_act<float>(act, a, w, scale, bias, c, m, n, k, s);
  } else {
    rc = launch_act<__nv_bfloat16>(act, a, w, scale, bias, c, m, n, k, s);
  }
  if (rc != (int)cudaSuccess) return rc;
  return (int)cudaGetLastError();
}
