// K4: weight gradient of the sparse convolution's gather-GEMM.
//
//   dW[k] = sum_{b, m} feats[b, idx[b, m, k]]^T (outer) dout[b, m]
//
// in float32, [K, C, E].
//
// A miss (idx == N) adds zero.
//
// Replaces the TPU kernel fcaf3d_tpu/ops/sparse/gather_kernel.py::
// _fused_dw_pallas (entry fused_gather_dw), which selects window rows with
// one-hot matmuls and keeps a [k_chunk, C, E] output block resident in VMEM
// across a sequential grid.
//
// What bounds it on the H100: 2 * B * M * K * C * E multiply-adds over the
// rows that hit (~50 GFLOP for the s8 64x64 convs at batch 8) against one
// read of the gathered feats rows and the dout rows per (offset, channel
// tile): compute bound. This kernel runs float FMAs on the CUDA cores (67
// TFLOP/s peak), so it is bound by issue rate, at a fraction of that; bf16
// on the tensor cores' granule takes `gather_dw_tc.cu`.
//
// Design, kept simple on purpose. Blocks run in no order, so nothing is
// carried between them: one block per (64 output channels E, 64 input
// channels C, offset k, slice s of the B * M rows). A block walks its slice
// in tiles of 32 rows. For each tile, warp 0 reads the 32 map entries and
// compacts the rows that hit (ballot + popc), so misses cost nothing and a
// tile with no hit is skipped. The hit rows of feats (C tile) and of dout
// (E tile) are staged in shared memory as float, and each of the 256
// threads accumulates a 4x4 block of dW in float registers, rows in order.
// Each block writes its partial to part[s, k, c, e]; a second kernel sums the
// slices in slice order. There are no float atomics, so a repeated backward
// is bitwise equal. No C, E, M or K needs to be a multiple of anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elementwise.cuh"
#include "sum_slices.cuh"

namespace {

constexpr int kTileR = 32;   // rows per tile (one warp ballot)
constexpr int kTileC = 64;   // input channels per block
constexpr int kTileE = 64;   // output channels per block
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(kThreads) gather_dw_kernel(
    const T* __restrict__ feats, const int32_t* __restrict__ idx,
    const T* __restrict__ dout, float* __restrict__ part, int n_rows,
    int m_rows, int n_offsets, int channels, int out_channels,
    int64_t total_rows, int64_t rows_per_slice, int n_slices) {
  __shared__ float a_tile[kTileR][kTileC + 1];  // +1: no bank conflicts
  __shared__ float d_tile[kTileR][kTileE];
  __shared__ int64_t feat_off[kTileR];  // element offset of a hit feats row
  __shared__ int64_t dout_row[kTileR];  // flat (b, m) row of that hit
  __shared__ int n_hit;

  const int e0 = blockIdx.x * kTileE;
  const int c0 = blockIdx.y * kTileC;
  const int k = blockIdx.z / n_slices;
  const int s = blockIdx.z % n_slices;
  const int64_t r_begin = (int64_t)s * rows_per_slice;
  const int64_t r_end = min(total_rows, r_begin + rows_per_slice);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels e0 + tx + 16 j
  const int ty = tid / 16;  // input channels c0 + ty + 16 i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += kTileR) {
    if (tid < kTileR) {  // warp 0: compact the tile's hit rows, in order
      const int64_t r = r0 + tid;
      int row = n_rows;
      if (r < r_end) row = idx[r * n_offsets + k];
      const bool hit = row < n_rows;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int pos = __popc(mask & ((1u << tid) - 1u));
        feat_off[pos] = ((r / m_rows) * n_rows + row) * (int64_t)channels;
        dout_row[pos] = r;
      }
      if (tid == 0) n_hit = __popc(mask);
    }
    __syncthreads();
    const int hits = n_hit;
    if (hits == 0) {
      __syncthreads();  // n_hit is rewritten by the next tile
      continue;
    }
    for (int i = tid; i < hits * kTileC; i += kThreads) {
      const int rr = i / kTileC, c = i % kTileC;
      a_tile[rr][c] = c0 + c < channels
                          ? to_float(feats[feat_off[rr] + c0 + c])
                          : 0.f;
    }
    for (int i = tid; i < hits * kTileE; i += kThreads) {
      const int rr = i / kTileE, e = i % kTileE;
      d_tile[rr][e] =
          e0 + e < out_channels
              ? to_float(dout[dout_row[rr] * out_channels + e0 + e])
              : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < hits; ++rr) {
      float a[4], d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_tile[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = d_tile[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + ((int64_t)s * n_offsets + k) * channels * out_channels;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= channels) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e < out_channels) out[(int64_t)c * out_channels + e] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* feats, const int32_t* idx, const void* dout,
           float* part, float* out, int64_t batch, int64_t n_rows,
           int64_t m_rows, int64_t n_offsets, int64_t channels,
           int64_t out_channels, int64_t rows_per_slice, int64_t n_slices,
           cudaStream_t stream) {
  const int64_t size = n_offsets * channels * out_channels;
  if (size == 0) return 0;
  if (batch * m_rows == 0)
    return (int)cudaMemsetAsync(out, 0, size * sizeof(float), stream);
  float* dst = n_slices == 1 ? out : part;
  const dim3 grid((unsigned)((out_channels + kTileE - 1) / kTileE),
                  (unsigned)((channels + kTileC - 1) / kTileC),
                  (unsigned)(n_offsets * n_slices));
  gather_dw_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)feats, idx, (const T*)dout, dst, (int)n_rows, (int)m_rows,
      (int)n_offsets, (int)channels, (int)out_channels, batch * m_rows,
      rows_per_slice, (int)n_slices);
  int err = (int)cudaGetLastError();
  if (err != 0 || n_slices == 1) return err;
  return sum_slices(part, out, size, (int)n_slices, stream);
}

}  // namespace

// feats [B, N, C] and dout [B, M, E] in one dtype (0 = float32,
// 1 = bfloat16); idx [B, M, K] int32 in [0, N]; out [K, C, E] float32. The
// B * M rows are cut into n_slices slices of rows_per_slice rows; part is
// float32 scratch [n_slices, K, C, E] (unused, may be null, when n_slices is
// 1). Returns the first non-zero cudaError_t of the launches, or
// cudaErrorInvalidValue for an unknown dtype.
extern "C" int fcaf3d_gather_dw(const void* feats, const int32_t* idx,
                                const void* dout, float* part, float* out,
                                int64_t batch, int64_t n_rows, int64_t m_rows,
                                int64_t n_offsets, int64_t channels,
                                int64_t out_channels, int64_t rows_per_slice,
                                int64_t n_slices, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(feats, idx, dout, part, out, batch, n_rows, m_rows,
                         n_offsets, channels, out_channels, rows_per_slice,
                         n_slices, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, idx, dout, part, out, batch, n_rows,
                                 m_rows, n_offsets, channels, out_channels,
                                 rows_per_slice, n_slices, s);
  return (int)cudaErrorInvalidValue;
}
