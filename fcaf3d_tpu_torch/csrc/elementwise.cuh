// Element-wise device helpers shared by the kernels: the float conversions
// of the two activation dtypes (K2 `gather_gemm_simt.cu`, K3
// `gather_max.cu`, K4 `gather_dw.cu`, K7 `masked_norm.cu`) and K2's
// epilogue activation (`gather_gemm_simt.cu`, `gather_gemm_tc.cu`).
//
// A float becomes bf16 by round-to-nearest-even (__float2bfloat16_rn), as
// the plain path's cast rounds. K2's ELU is exp(min(y, 0)) - 1 as the TPU
// kernel computes it, the subtraction rounded on its own; the plain path's
// expm1 agrees within 1e-7. K7's ELU is expm1f, its own.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace {

// activation codes, as the wrappers pass them
constexpr int kNone = 0, kRelu = 1, kElu = 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// K2's epilogue activation `act` (kNone, kRelu or kElu) of y.
__device__ __forceinline__ float epilogue_act(float y, int act) {
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kElu) return y > 0.f ? y : __fsub_rn(expf(fminf(y, 0.f)), 1.f);
  return y;
}

}  // namespace
