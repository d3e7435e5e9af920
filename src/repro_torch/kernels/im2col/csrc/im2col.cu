// im2col: the patch matrix of a convolution, written once from NHWC x, for
// Hopper (sm_90a).
//
// out is the row-major (m, k) matrix with m = N*OH*OW and k = KH*KW*C.  Row
// r = (n, oy, ox) and column q = (i, j, c) hold
// x[n, oy*s + i - p, ox*s + j - p, c], or 0 where the patch reaches into
// the padding: the (kh, kw, cin) column order that the conv weights'
// reshape and the FC flatten of models/cnn.py depend on.  A copy does no
// arithmetic, so the patches are bitwise those of the plain version
// (kernels/im2col/ref.py) on every dtype.
//
// Replaces no TPU kernel: repro's im2col is a jnp gather that XLA fuses
// into one pass.  The plain version, run on the card, padded x, gathered
// rows and then columns through index grids uploaded from the host at
// every call, and copied the permuted result: the patches written three
// times, and the host stalled until the stream drained at each upload.
// This kernel writes them once and computes every index on the card.
//
// What bounds it: device-memory bytes.  The patch matrix is written once,
// KH*KW times the bytes of x (less at the padded border); x itself is read
// from device memory about once, since neighbouring rows share most of
// their input pixels and run close together.  CIFAR_Alex+'s three convs
// write 2,355,200 B a frame: 0.720 ms a batch of 1,024 at 3.35 TB/s.
//
// What the design does about it:
// - Each thread moves vectors of VEC bytes: the widest of 16, 8, 4, 2 and 1
//   that divides both C and k times the element size (im2col_vec), so a
//   vector never crosses an (i, j) segment and every row of out starts on
//   a VEC boundary.  Consecutive threads write consecutive vectors, so the
//   stores are coalesced.  The width follows the shape and the dtype alone.
// - A block owns a tile of up to ROWS_MAX consecutive rows by up to QMAX
//   vectors of them.  It first decodes its columns (q -> i, j and the
//   offset from the patch's origin) and its rows (r -> the origin's pixel)
//   into shared memory; the copy loop then steps through the tile by the
//   block's size with no division.
// - Each thread loads UNROLL vectors before it stores them, so that as
//   many loads are in flight, and stores with the streaming hint.
// - Blocks walk the rows in order, so rows of neighbouring ox, which share
//   most of their input pixels, run close together and find x in L1/L2.
// - Offsets into x and out are 64-bit: conv2 at batch 1,024 writes
//   4.2 x 10^8 elements.
//
// Interface: plain C, bound with ctypes.  The launch goes on the caller's
// stream, allocates nothing and does not synchronise; the function returns
// the CUDA error of the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QMAX = 1024;      // vectors of a row a block decodes at once
constexpr int ROWS_MAX = 128;   // rows a block decodes at once
constexpr int TILE = 8192;      // vectors a block copies: 32 a thread
constexpr int UNROLL = 4;       // vectors a thread loads before it stores

template <int VEC>
struct Vec;
template <>
struct Vec<16> { using T = uint4; };
template <>
struct Vec<8> { using T = uint2; };
template <>
struct Vec<4> { using T = unsigned int; };
template <>
struct Vec<2> { using T = unsigned short; };
template <>
struct Vec<1> { using T = unsigned char; };

// Counts in vectors of VEC bytes, except the pixel and kernel geometry.
struct Geometry {
  int h, w;         // the input's rows and columns
  int cv;           // vectors a pixel (C * elem / VEC)
  int oh, ow;       // the output's rows and columns
  int kw, stride, pad;
  int vpr;          // vectors a row of out (k * elem / VEC)
  int m;            // rows of out
  int rows, cols;   // a block's tile: rows x vectors
};

template <typename V>
__global__ void __launch_bounds__(THREADS)
im2col_kernel(const V* __restrict__ x, V* __restrict__ out, Geometry g) {
  // a column: (its offset in x from the patch's origin, (i << 16) | j)
  __shared__ int2 col[QMAX];
  // a row: the offset in x of its patch's origin pixel, and (iy0, ix0)
  __shared__ long long row_base[ROWS_MAX];
  __shared__ int2 row_org[ROWS_MAX];

  const int r0 = blockIdx.x * g.rows;
  const int q0 = blockIdx.y * g.cols;
  const int rows = min(g.rows, g.m - r0);
  const int cols = min(g.cols, g.vpr - q0);
  for (int t = threadIdx.x; t < cols; t += THREADS) {
    const int q = q0 + t;
    const int seg = q / g.cv;
    const int i = seg / g.kw;
    const int j = seg - i * g.kw;
    col[t] = make_int2((i * g.w + j) * g.cv + (q - seg * g.cv),
                       (i << 16) | j);
  }
  for (int t = threadIdx.x; t < rows; t += THREADS) {
    const int r = r0 + t;
    const int ox = r % g.ow;
    const int rest = r / g.ow;
    const int oy = rest % g.oh;
    const int n = rest / g.oh;
    const int iy0 = oy * g.stride - g.pad;
    const int ix0 = ox * g.stride - g.pad;
    row_base[t] = (((long long)n * g.h + iy0) * g.w + ix0) * g.cv;
    row_org[t] = make_int2(iy0, ix0);
  }
  __syncthreads();

  // thread t copies the tile's vectors t, t + THREADS, ... in row-major
  // order: (rr, c) advances by (THREADS / cols, THREADS % cols).  UNROLL
  // of them are loaded before any is stored, so that as many loads are in
  // flight.
  int rr = threadIdx.x / cols;
  int c = threadIdx.x - rr * cols;
  const int drr = THREADS / cols;
  const int dc = THREADS - drr * cols;
  V* dst = out + (long long)r0 * g.vpr + q0;
  while (rr < rows) {
    V v[UNROLL];
    long long at[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      v[u] = V{};
      at[u] = -1;
      if (rr < rows) {
        const int2 cc = col[c];
        const int2 org = row_org[rr];
        const int iy = org.x + (cc.y >> 16);
        const int ix = org.y + (cc.y & 0xffff);
        if ((unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.w) {
          v[u] = __ldg(x + row_base[rr] + cc.x);
        }
        at[u] = (long long)rr * g.vpr + c;
        c += dc;
        rr += drr;
        if (c >= cols) {
          c -= cols;
          ++rr;
        }
      }
    }
    // streaming stores: the GEMM reads the patches once, and at the
    // main path's batches they are larger than L2
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (at[u] >= 0) __stcs(dst + at[u], v[u]);
    }
  }
}

// The widest access that divides both byte counts.
int vec_bytes(long long c_bytes, long long k_bytes) {
  for (int v = 16; v > 1; v /= 2) {
    if (c_bytes % v == 0 && k_bytes % v == 0) return v;
  }
  return 1;
}

template <int VEC>
int launch(const void* x, void* out, Geometry g, long long c_bytes,
           long long k_bytes, cudaStream_t s) {
  using V = typename Vec<VEC>::T;
  g.cv = (int)(c_bytes / VEC);
  g.vpr = (int)(k_bytes / VEC);
  g.cols = g.vpr < QMAX ? g.vpr : QMAX;
  g.rows = TILE / g.cols;
  g.rows = g.rows < 1 ? 1 : (g.rows > ROWS_MAX ? ROWS_MAX : g.rows);
  dim3 grid((g.m + g.rows - 1) / g.rows, (g.vpr + g.cols - 1) / g.cols);
  im2col_kernel<V><<<grid, THREADS, 0, s>>>(static_cast<const V*>(x),
                                            static_cast<V*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

// The access width in bytes the kernel takes for C channels, k = KH*KW*C
// columns and elements of elem_size bytes.
extern "C" int im2col_vec(int c, int k, int elem_size) {
  return vec_bytes((long long)c * elem_size, (long long)k * elem_size);
}

// x: contiguous (n, h, w, c), on a boundary of im2col_vec bytes; out:
// contiguous (n * oh * ow, kh * kw * c), same dtype, elem_size bytes an
// element.  (oh, ow) must be the convolution's output size; the rows, the
// columns and the elements of one padded image must each fit in an int.
extern "C" int im2col(const void* x, void* out, int n, int h, int w, int c,
                      int kh, int kw, int stride, int pad, int oh, int ow,
                      int elem_size, void* stream) {
  const long long k = (long long)kh * kw * c;
  const long long m = (long long)n * oh * ow;
  if (n < 1 || h < 1 || w < 1 || c < 1 || kh < 1 || kw < 1 || stride < 1 ||
      pad < 0 || kh >= (1 << 15) || kw >= (1 << 15) ||
      oh != (h + 2 * pad - kh) / stride + 1 ||
      ow != (w + 2 * pad - kw) / stride + 1 || oh < 1 || ow < 1 ||
      m > INT_MAX || k > INT_MAX ||
      (long long)(h + 2 * pad) * (w + 2 * pad) * c > INT_MAX ||
      (elem_size != 1 && elem_size != 2 && elem_size != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g{};
  g.h = h;
  g.w = w;
  g.oh = oh;
  g.ow = ow;
  g.kw = kw;
  g.stride = stride;
  g.pad = pad;
  g.m = (int)m;
  const long long c_bytes = (long long)c * elem_size;
  const long long k_bytes = k * elem_size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes(c_bytes, k_bytes)) {
    case 16: return launch<16>(x, out, g, c_bytes, k_bytes, s);
    case 8: return launch<8>(x, out, g, c_bytes, k_bytes, s);
    case 4: return launch<4>(x, out, g, c_bytes, k_bytes, s);
    case 2: return launch<2>(x, out, g, c_bytes, k_bytes, s);
    default: return launch<1>(x, out, g, c_bytes, k_bytes, s);
  }
}
