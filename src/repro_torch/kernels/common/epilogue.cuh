// Shared by the port's GEMM kernels (tiled_mm.cu, vpu_mm.cu): the element
// conversions and the fused epilogue act(acc + bias), as ONE device
// function (flash_attention.cu and ssd.cu use the conversions; qmm.cu the
// activations and the paired stores of an mma accumulator fragment).  In fp32
// each kernel sums an output's k products from 0.0f with one fmaf per k
// in increasing k; with the same epilogue on top, a row panel gives the
// same bits whichever kernel ran it, which is what lets the runtime split
// one GEMM across both and merge bitwise.  (tiled_mm's bf16 paths run on
// the tensor cores and keep that promise among their own row panels
// only.)  Both sources are
// compiled with the same nvcc flags and never with --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace synergy {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T's precision and back: what a float becomes once stored in T
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

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == ACT_RELU) return fmaxf(y, 0.0f);
  if (ACT == ACT_SILU) return y / (1.0f + expf(-y));
  return y;
}

// bias[col], or 0.0f without a bias: the one place either kernel reads it
__device__ __forceinline__ float bias_at(const float* __restrict__ bias,
                                         int col) {
  return bias != nullptr ? bias[col] : 0.0f;
}

// c[...] = act(acc + bias_col), in the output's type
template <int ACT, typename TOut>
__device__ __forceinline__ void epilogue_store(TOut* p, float acc,
                                               float bias_col) {
  store(p, activate<ACT>(acc + bias_col));
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(int* p, int v0, int v1) {
  *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
}

// the same for two neighbouring columns of one row, as the tensor-core
// kernels hold them in one thread's accumulator registers (p aligned to
// two elements): one vector store, the same bits as two epilogue_store
template <int ACT, typename TOut>
__device__ __forceinline__ void epilogue_store2(TOut* p, float acc0,
                                                float acc1, float bias0,
                                                float bias1) {
  store2(p, activate<ACT>(acc0 + bias0), activate<ACT>(acc1 + bias1));
}

// The C entry points' argument check (m, n >= 1, k >= 0, known codes).
inline bool gemm_args_ok(int m, int n, int k, int in_dtype, int out_dtype,
                         int act) {
  return m >= 1 && n >= 1 && k >= 0 && act >= ACT_NONE && act <= ACT_SILU &&
         (in_dtype == DT_F32 || in_dtype == DT_BF16) &&
         (out_dtype == DT_F32 || out_dtype == DT_BF16);
}

// Calls f(TIn{}, TOut{}, std::integral_constant<int, ACT>{}) for the
// entry point's runtime codes, so each kernel instantiates its template
// for the four type pairs and three epilogues from one switch.
template <typename TIn, typename TOut, typename F>
void dispatch_act(int act, F&& f) {
  switch (act) {
    case ACT_RELU: f(TIn{}, TOut{}, std::integral_constant<int, ACT_RELU>{});
      break;
    case ACT_SILU: f(TIn{}, TOut{}, std::integral_constant<int, ACT_SILU>{});
      break;
    default: f(TIn{}, TOut{}, std::integral_constant<int, ACT_NONE>{});
      break;
  }
}

template <typename F>
void dispatch_gemm(int in_dtype, int out_dtype, int act, F&& f) {
  if (in_dtype == DT_F32 && out_dtype == DT_F32) {
    dispatch_act<float, float>(act, f);
  } else if (in_dtype == DT_F32) {
    dispatch_act<float, __nv_bfloat16>(act, f);
  } else if (out_dtype == DT_F32) {
    dispatch_act<__nv_bfloat16, float>(act, f);
  } else {
    dispatch_act<__nv_bfloat16, __nv_bfloat16>(act, f);
  }
}

}  // namespace synergy
