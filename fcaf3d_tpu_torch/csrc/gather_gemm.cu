// K2: sparse convolution as a gather-GEMM, with the folded inference epilogue.
//
//   out[b, m] = act(sum_k feats[b, idx[b, m, k]] @ W[k] * scale + shift
//                   [+ add[b, m]]) * vmask[b, m]
//
// A miss (idx == N) adds zero; without `scale` there is no epilogue at all.
//
// Replaces the TPU kernel fcaf3d_tpu/ops/sparse/gather_kernel.py::_fused_pallas
// (entry fused_gather_gemm), which DMAs a window of input rows per output tile
// and selects rows with one-hot matmuls on the MXU.
//
// What bounds it on the H100: the main path's convs carry ~0.5 TFLOP of dense
// (gathered) multiply-adds per scan against ~1 GB of gathered rows, so a good
// kernel is compute bound on the tensor cores. This first version is not: it
// runs float FMAs on the CUDA cores (67 TFLOP/s peak), so it is bound by
// issue rate, at a fraction of that.
//
// Design, kept simple on purpose: one block per (sample, 64 output rows,
// 64 output channels). For each offset k in index order, the block loads the
// tile's 64 row indices; if none hits, the offset is skipped (the padding
// tail of every map and most offsets of sparse tiles). Otherwise, for each
// 32-channel slice of the input, it gathers the 64 input rows into shared
// memory (a miss gives a zero row), stages W[k]'s slice, and each of the 256
// threads accumulates a 4x4 block of outputs in float registers. Offsets are
// summed in index order within the three offset chunks the plain version uses
// (np.linspace(0, K, 4)), and the chunk sums are added in order, so the
// rounding follows the plain version's. The epilogue runs in the store, in
// float, with separate multiply and add roundings as in the plain version.
// No C, E, M or K needs to be a multiple of anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;   // output rows per block
constexpr int kTileE = 64;   // output channels per block
constexpr int kTileC = 32;   // input channels staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

enum Act { kNone = 0, kRelu = 1, kElu = 2 };

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
__global__ void __launch_bounds__(kThreads) gather_gemm_kernel(
    const T* __restrict__ feats, const int32_t* __restrict__ idx,
    const T* __restrict__ weight, const float* __restrict__ scale,
    const float* __restrict__ shift, const T* __restrict__ add,
    const uint8_t* __restrict__ vmask, T* __restrict__ out, int n_rows,
    int m_rows, int n_offsets, int channels, int out_channels, int chunk1,
    int chunk2, int act) {
  __shared__ float a_tile[kTileM][kTileC + 1];  // +1: no bank conflicts
  __shared__ float w_tile[kTileC][kTileE];
  __shared__ int rows[kTileM];

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * kTileM;
  const int e0 = blockIdx.x * kTileE;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels e0 + tx + 16 j
  const int ty = tid / 16;  // output rows m0 + ty + 16 i
  const T* fb = feats + (int64_t)b * n_rows * channels;

  float total[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) total[i][j] = part[i][j] = 0.f;

  for (int k = 0; k < n_offsets; ++k) {
    if (k == chunk1 || k == chunk2) {  // close an offset chunk, in order
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          total[i][j] = __fadd_rn(total[i][j], part[i][j]);
          part[i][j] = 0.f;
        }
    }
    int hit = 0;
    if (tid < kTileM) {
      const int m = m0 + tid;
      const int r = m < m_rows ? idx[((int64_t)b * m_rows + m) * n_offsets + k]
                               : n_rows;
      rows[tid] = r;
      hit = r < n_rows;
    }
    // barrier + vote: `rows` is visible, and the whole block agrees to skip
    if (!__syncthreads_or(hit)) continue;
    for (int c0 = 0; c0 < channels; c0 += kTileC) {
      for (int i = tid; i < kTileM * kTileC; i += kThreads) {
        const int r = i / kTileC, c = i % kTileC;
        const int row = rows[r];
        a_tile[r][c] = (row < n_rows && c0 + c < channels)
                           ? to_float(fb[(int64_t)row * channels + c0 + c])
                           : 0.f;
      }
      for (int i = tid; i < kTileC * kTileE; i += kThreads) {
        const int c = i / kTileE, e = i % kTileE;
        w_tile[c][e] =
            (c0 + c < channels && e0 + e < out_channels)
                ? to_float(weight[((int64_t)k * channels + c0 + c) *
                                      out_channels + e0 + e])
                : 0.f;
      }
      __syncthreads();
      const int c_end = min(kTileC, channels - c0);
      for (int c = 0; c < c_end; ++c) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = a_tile[ty + 16 * i][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = w_tile[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], w[j], part[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= m_rows) continue;
    const int64_t row = (int64_t)b * m_rows + m;
    const float vm = vmask != nullptr ? (float)vmask[row] : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e >= out_channels) continue;
      float y = __fadd_rn(total[i][j], part[i][j]);
      if (scale != nullptr) {
        y = __fadd_rn(__fmul_rn(y, scale[e]), shift[e]);
        if (add != nullptr)
          y = __fadd_rn(y, to_float(add[row * out_channels + e]));
        if (act == kRelu) {
          y = fmaxf(y, 0.f);
        } else if (act == kElu) {
          y = y > 0.f ? y : __fsub_rn(expf(fminf(y, 0.f)), 1.f);
        }
        y = __fmul_rn(y, vm);
      }
      out[row * out_channels + e] = from_float<T>(y);
    }
  }
}

template <typename T>
int launch(const void* feats, const int32_t* idx, const void* weight,
           const float* scale, const float* shift, const void* add,
           const uint8_t* vmask, void* out, int64_t batch, int64_t n_rows,
           int64_t m_rows, int64_t n_offsets, int64_t channels,
           int64_t out_channels, int64_t chunk1, int64_t chunk2, int act,
           cudaStream_t stream) {
  if (batch == 0 || m_rows == 0 || out_channels == 0) return 0;
  const dim3 grid((unsigned)((out_channels + kTileE - 1) / kTileE),
                  (unsigned)((m_rows + kTileM - 1) / kTileM), (unsigned)batch);
  gather_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)feats, idx, (const T*)weight, scale, shift, (const T*)add,
      vmask, (T*)out, (int)n_rows, (int)m_rows, (int)n_offsets, (int)channels,
      (int)out_channels, (int)chunk1, (int)chunk2, act);
  return (int)cudaGetLastError();
}

}  // namespace

// feats [B, N, C]; idx [B, M, K] int32 in [0, N]; weight [K, C, E]; out
// [B, M, E], all in one dtype (0 = float32, 1 = bfloat16). scale/shift [E]
// float32 or both null (then add and vmask must be null too); add [B, M, E]
// in the feats dtype or null; vmask [B, M] uint8 or null. chunk1 <= chunk2
// split the offsets into the three summation chunks. act: 0 none, 1 relu,
// 2 elu. Returns the cudaError_t of the launch, or cudaErrorInvalidValue for
// an unknown dtype.
extern "C" int fcaf3d_gather_gemm(const void* feats, const int32_t* idx,
                                  const void* weight, const float* scale,
                                  const float* shift, const void* add,
                                  const uint8_t* vmask, void* out,
                                  int64_t batch, int64_t n_rows, int64_t m_rows,
                                  int64_t n_offsets, int64_t channels,
                                  int64_t out_channels, int64_t chunk1,
                                  int64_t chunk2, int dtype, int act,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(feats, idx, weight, scale, shift, add, vmask, out,
                         batch, n_rows, m_rows, n_offsets, channels,
                         out_channels, chunk1, chunk2, act, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, idx, weight, scale, shift, add, vmask,
                                 out, batch, n_rows, m_rows, n_offsets,
                                 channels, out_channels, chunk1, chunk2, act,
                                 s);
  return (int)cudaErrorInvalidValue;
}
