// The second pass of K4 (`gather_dw.cu`, `gather_dw_tc.cu`): each block of
// the first pass wrote the partial dW of one slice of the rows; the slices
// are added here in slice order, so a repeated backward is bitwise equal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSumThreads = 256;

// out[i] = sum_s part[s, i], slices added in order.
__global__ void sum_slices_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int64_t size,
                                  int n_slices) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= size) return;
  float total = part[i];
#pragma unroll 8
  for (int s = 1; s < n_slices; ++s) total += part[(int64_t)s * size + i];
  out[i] = total;
}

// Launches the sum of n_slices partials [n_slices, size] into out [size].
inline int sum_slices(const float* part, float* out, int64_t size,
                      int n_slices, cudaStream_t stream) {
  sum_slices_kernel<<<(unsigned)((size + kSumThreads - 1) / kSumThreads),
                      kSumThreads, 0, stream>>>(part, out, size, n_slices);
  return (int)cudaGetLastError();
}

}  // namespace
