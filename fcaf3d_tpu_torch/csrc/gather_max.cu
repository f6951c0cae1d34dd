// K3: per-channel max over the rows a kernel map gathers.
//
// Replaces the TPU kernel
// fcaf3d_tpu/ops/sparse/gather_kernel.py::_fused_max_pallas (entry
// fused_gather_max), which selects window rows with one-hot matmuls.
//
// What bounds it on the H100: on the main path it runs once, for the stem's
// k2 s2 max-pool: idx [1, ~40k, 8] gathers 64-channel rows, ~40 MB of reads
// at most. It is bound by memory traffic (and by latency at this small size).
//
// Design: one thread per (sample, output row, channel). Neighbouring threads
// take neighbouring channels of the same gathered row, so each row read is
// coalesced. The max runs in float, which is exact for f32 and bf16 inputs;
// a miss (idx == N) is skipped, and a row with no hit returns `lowest`
// (finfo(dtype).min), which the caller masks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void gather_max_kernel(const T* __restrict__ feats,
                                  const int32_t* __restrict__ idx,
                                  T* __restrict__ out, int64_t n_rows,
                                  int64_t m_rows, int n_offsets,
                                  int64_t channels, int64_t total,
                                  float lowest) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t c = i % channels;
  const int64_t bm = i / channels;
  const T* f = feats + (bm / m_rows) * n_rows * channels + c;
  const int32_t* ix = idx + bm * n_offsets;
  float best = -INFINITY;
  bool any = false;
  for (int k = 0; k < n_offsets; ++k) {
    const int32_t r = ix[k];
    if (r < n_rows) {
      best = fmaxf(best, to_float(f[(int64_t)r * channels]));
      any = true;
    }
  }
  out[i] = from_float<T>(any ? best : lowest);
}

template <typename T>
int launch(const void* feats, const int32_t* idx, void* out, int64_t batch,
           int64_t n_rows, int64_t m_rows, int64_t n_offsets, int64_t channels,
           float lowest, cudaStream_t stream) {
  const int64_t total = batch * m_rows * channels;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  gather_max_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)feats, idx, (T*)out, n_rows, m_rows, (int)n_offsets, channels,
      total, lowest);
  return (int)cudaGetLastError();
}

}  // namespace

// feats [B, N, C]; idx [B, M, K] int32 in [0, N]; out [B, M, C] in the feats
// dtype (dtype 0 = float32, 1 = bfloat16). Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue for an unknown dtype.
extern "C" int fcaf3d_gather_max(const void* feats, const int32_t* idx,
                                 void* out, int64_t batch, int64_t n_rows,
                                 int64_t m_rows, int64_t n_offsets,
                                 int64_t channels, int dtype, float lowest,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(feats, idx, out, batch, n_rows, m_rows, n_offsets,
                         channels, lowest, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, idx, out, batch, n_rows, m_rows,
                                 n_offsets, channels, lowest, s);
  return (int)cudaErrorInvalidValue;
}
