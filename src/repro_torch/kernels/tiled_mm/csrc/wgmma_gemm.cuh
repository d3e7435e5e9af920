// tiled_mm's bf16 path for aligned shapes: Hopper's warpgroup MMA
// (wgmma.mma_async m64nBNk16, fp32 accumulators in registers) fed by TMA
// through a four-stage shared-memory ring.
//
// Block: 384 threads, one output tile of 128 x BN, BN = 256 for wide n
// (so each byte staged from L2 feeds more products: a 128 x 128 tile moves
// 1.3 MB per 84 MFLOP at k = 2560, which at the tensor cores' rate is more
// than L2 delivers) and 128 otherwise (more tiles for the card's 132 SMs).
// Warpgroup 0 is the producer: one thread keeps the ring full, each stage
// one 128 x 64 tile of A and one 64 x BN tile of B (cp.async.bulk.tensor,
// 128-byte swizzle, completion counted in bytes on the stage's "full"
// mbarrier).  Warpgroups 1 and 2 are the consumers: each owns 64 rows of
// the output tile and issues four wgmma per stage (k = 64) straight from
// shared memory; the stage is handed back on its "empty" mbarrier (one
// arrival per consumer warp) once the wgmma of the NEXT stage are in
// flight, so loads, products and the hand-back overlap.
//
// Layouts.  A (m, k) is row-major, so K-major for wgmma: rows of 64 bf16
// (128 bytes), swizzled in atoms of 8 rows (SBO 1024 bytes); a k16 step
// moves the descriptor 32 bytes along the row.  B (k, n) is row-major, so
// MN-major: it is read with the descriptor's transpose bit, never
// transposed in memory.  A 128-byte row holds 64 columns of n, so a
// stage's B is BN / 64 TMA boxes of 64 k-rows x 64 columns: atoms of 8 k-rows
// x 64 columns, the next 8 k-rows 1024 bytes on (SBO), the next 64
// columns one box (8192 bytes) on (LBO); a k16 step moves 16 rows (2048
// bytes).
//
// Ragged edges: TMA fills rows past m, columns past n and k past k with
// zeros, which add nothing to a sum, and the epilogue stores only inside
// (m, n).  So an output element's bits depend on its row of A, on B and on
// k only: the k steps run in the same order for every row, whichever tile
// or row panel holds it, and m never changes the path or the order.
//
// Host side: the TMA descriptors are encoded per call (the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so that
// nothing links against libcuda) and passed as __grid_constant__ kernel
// parameters.  TMA needs the operands' base addresses and row strides on
// 16 bytes: k % 8 == 0 and n % 8 == 0 choose this path, and the wrapper
// hands over 16-byte aligned tensors.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "ptx.cuh"

namespace synergy {
namespace wgmma_gemm {

constexpr int BM = 128;                  // output tile rows
constexpr int BK = 64;                   // k per stage: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;             // warpgroups, 64 rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int GROUP_M = 8;               // row tiles that walk n together
constexpr int WIDE_N = 8192;             // n from which tiles are 256 wide
constexpr int B_BOX = 64;                // columns of n per TMA box
constexpr int A_BYTES = BM * BK * 2;     // 16 KB

// the shared-memory ring of a 128 x BN tile
template <int BN>
struct Ring {
  static constexpr int B_BYTES = BK * BN * 2;    // BN / 64 boxes of 8 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_BYTES +
                                       2 * STAGES * sizeof(uint64_t) + 1024;
};
// wgmma descriptor strides, in bytes (see the note above)
constexpr uint32_t A_SBO = 1024;
constexpr uint32_t B_LBO = BK * 128;
constexpr uint32_t B_SBO = 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a box of a 2-d tensor map at (c0 innermost, c1) into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle (strides in bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that own them
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) * B (16 x 128, MN-major: transpose bit set)
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d += A (64 x 16, K-major) * B (16 x 256, MN-major: transpose bit set)
__device__ __forceinline__ void wgmma_k16(float (&d)[128], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN, typename TOut, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
tiled_mm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b,
                      const float* __restrict__ bias,
                      TOut* __restrict__ c, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles sit on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  constexpr int STAGE_BYTES = Ring<BN>::STAGE_BYTES;
  constexpr int B_BYTES = Ring<BN>::B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // groups of GROUP_M row tiles walk the column tiles together, so the A
  // and B tiles a wave of blocks reads stay in L2
  const int tiles_m = (m + BM - 1) / BM;
  const int tiles_n = (n + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int row0 = (first_m + in_group % group_m) * BM;
  const int col0 = (in_group / group_m) * BN;
  const int k_tiles = (k + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps up to STAGES tiles in flight
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* sa = smem + s * STAGE_BYTES;
        uint8_t* sb = sa + A_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(sa, &tma_a, &full[s], kt * BK, row0);
#pragma unroll
        for (int box = 0; box < BN / B_BOX; ++box) {
          tma_load_2d(sb + box * (B_BYTES * B_BOX / BN), &tma_b, &full[s],
                      col0 + box * B_BOX, kt * BK);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows (wg - 1) * 64 .. + 63 of the tile
  const int half = wg - 1;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
  fence_acc(d);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t sa = smem_addr(smem + s * STAGE_BYTES) + half * 64 * 128;
    const uint32_t sb = smem_addr(smem + s * STAGE_BYTES + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_k16(d, sw128_desc(sa + kk * 32, 16, A_SBO),
                sw128_desc(sb + kk * 16 * 128, B_LBO, B_SBO));
    }
    wgmma_commit();
    if (kt > 0) {
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (threadIdx.x % 32 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_acc(d);

  // epilogue on the accumulator registers: d[4 i + e] is row
  // 16 warp + lane / 4 (+ 8 for e >= 2), cols 8 i + 2 (lane % 4) (+ 1)
  const int t = threadIdx.x % 128;
  const int r = row0 + half * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = col0 + 8 * i + 2 * (t % 4);
    if (col >= n) continue;
    const float b0 = bias_at(bias, col);
    const float b1 = bias_at(bias, col + 1);
    if (r < m) {
      epilogue_store2<ACT>(&c[(int64_t)r * n + col], d[4 * i], d[4 * i + 1],
                           b0, b1);
    }
    if (r + 8 < m) {
      epilogue_store2<ACT>(&c[(int64_t)(r + 8) * n + col], d[4 * i + 2],
                           d[4 * i + 3], b0, b1);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major (rows, cols) bf16 matrix as a TMA map of (box_rows,
// box_cols) boxes, 128-byte swizzle, zeros outside the matrix
inline bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                       int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// m, n, k >= 1, n % 8 == 0, k % 8 == 0; a and b on 16 bytes
template <int BN, typename TOut, int ACT>
int launch_tile(const void* a, const void* b, const float* bias, TOut* c,
                int m, int n, int k, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  CUtensorMap tma_a, tma_b;
  if (!encode_map(&tma_a, a, m, k, BM, BK) ||
      !encode_map(&tma_b, b, k, n, BK, B_BOX)) {
    return (int)cudaErrorNotSupported;
  }
  constexpr size_t SMEM_BYTES = Ring<BN>::SMEM_BYTES;
  auto kernel = tiled_mm_wgmma_kernel<BN, TOut, ACT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, stream>>>(tma_a, tma_b,
                                                            bias, c, m, n, k);
  return (int)cudaGetLastError();
}

// BN by n alone (never by m, so a row panel keeps the whole GEMM's tile)
template <typename TOut, int ACT>
int launch(const void* a, const void* b, const float* bias, TOut* c, int m,
           int n, int k, cudaStream_t stream) {
  if (n >= WIDE_N) {
    return launch_tile<256, TOut, ACT>(a, b, bias, c, m, n, k, stream);
  }
  return launch_tile<128, TOut, ACT>(a, b, bias, c, m, n, k, stream);
}

}  // namespace wgmma_gemm
}  // namespace synergy
