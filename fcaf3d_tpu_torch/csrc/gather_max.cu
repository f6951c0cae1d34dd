// K3: per-channel max over the rows a kernel map gathers.
//
// Replaces the TPU kernel
// fcaf3d_tpu/ops/sparse/gather_kernel.py::_fused_max_pallas (entry
// fused_gather_max), which selects window rows with one-hot matmuls.
//
// What bounds it on the H100: on the main path it runs once, for the stem's
// k2 s2 max-pool: idx [B, ~40k, 8] gathers 64-channel rows. Each input row
// belongs to one window, so the compulsory traffic is about the feats, the
// map and the output once (~12 MB in bf16 at batch 1): bound by memory
// traffic, and at this size by how many loads are in flight.
//
// Design (`gather_max_vec`): one thread per (sample, output row, vector of
// VB bytes of channels): 16 bytes where C fills them (8 channels in bf16, 4
// in f32), else the widest of 8, 4 or 2 bytes that divides the row
// (`k3_plan` in ops/sparse/gather_kernel.py), so neighbouring threads read
// neighbouring vectors of one gathered row. A thread reads its row's map
// entries once (int4 loads where K % 4 == 0), then issues all gathers of a
// chunk of kChunk offsets (all 8 of the stem pool) as independent vector
// loads, skipping misses (idx == N), before it reduces them. The max runs
// in float (fmaxf), which is exact for f32 and bf16 inputs; a row with no
// hit returns `lowest` (finfo(dtype).min), which the caller masks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "elementwise.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // offsets whose gathers are in flight together

template <int VB>
struct Vec;
template <>
struct Vec<16> {
  using type = uint4;
};
template <>
struct Vec<8> {
  using type = uint2;
};
template <>
struct Vec<4> {
  using type = unsigned int;
};
template <>
struct Vec<2> {
  using type = unsigned short;
};

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
    gather_max_vec_kernel(const T* __restrict__ feats,
                          const int32_t* __restrict__ idx, T* __restrict__ out,
                          int64_t n_rows, int64_t m_rows, int n_offsets,
                          int64_t vecs, int64_t total, bool map4,
                          float lowest) {
  using V = typename Vec<VB>::type;
  constexpr int E = VB / (int)sizeof(T);  // channels a vector
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t bm = i / vecs;
  // vector i % vecs of row 0 of the sample: row r is `vecs` vectors on
  const V* f = reinterpret_cast<const V*>(feats) +
               (bm / m_rows) * n_rows * vecs + i % vecs;
  const int32_t* ix = idx + bm * n_offsets;
  float best[E];
#pragma unroll
  for (int e = 0; e < E; ++e) best[e] = -INFINITY;
  bool any = false;
  for (int k0 = 0; k0 < n_offsets; k0 += kChunk) {
    int32_t r[kChunk];
    if (map4) {  // K % 4 == 0: whole int4s, in or past the row together
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        int4 e4 = make_int4(INT32_MAX, INT32_MAX, INT32_MAX, INT32_MAX);
        if (k0 + 4 * q < n_offsets)
          e4 = __ldg(reinterpret_cast<const int4*>(ix + k0) + q);
        r[4 * q] = e4.x;
        r[4 * q + 1] = e4.y;
        r[4 * q + 2] = e4.z;
        r[4 * q + 3] = e4.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        r[j] = k0 + j < n_offsets ? __ldg(ix + k0 + j) : INT32_MAX;
    }
    V g[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)  // every gather in flight ...
      if (r[j] < n_rows) g[j] = __ldg(f + (int64_t)r[j] * vecs);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {  // ... before the first max
      if (r[j] >= n_rows) continue;
      T h[E];
      memcpy(h, &g[j], VB);
#pragma unroll
      for (int e = 0; e < E; ++e) best[e] = fmaxf(best[e], to_float(h[e]));
      any = true;
    }
  }
  T h[E];
#pragma unroll
  for (int e = 0; e < E; ++e) h[e] = from_float<T>(any ? best[e] : lowest);
  V res;
  memcpy(&res, h, VB);
  reinterpret_cast<V*>(out)[i] = res;
}

template <typename T, int VB>
int launch_vec(const void* feats, const int32_t* idx, void* out,
               int64_t batch, int64_t n_rows, int64_t m_rows,
               int64_t n_offsets, int64_t channels, bool map4, float lowest,
               cudaStream_t stream) {
  const int64_t vecs = channels * (int64_t)sizeof(T) / VB;
  const int64_t total = batch * m_rows * vecs;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  gather_max_vec_kernel<T, VB><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)feats, idx, (T*)out, n_rows, m_rows, (int)n_offsets, vecs,
      total, map4, lowest);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec_t(const void* feats, const int32_t* idx, void* out,
                 int64_t batch, int64_t n_rows, int64_t m_rows,
                 int64_t n_offsets, int64_t channels, int vector_bytes,
                 bool map4, float lowest, cudaStream_t s) {
  switch (vector_bytes) {
    case 16:
      return launch_vec<T, 16>(feats, idx, out, batch, n_rows, m_rows,
                               n_offsets, channels, map4, lowest, s);
    case 8:
      return launch_vec<T, 8>(feats, idx, out, batch, n_rows, m_rows,
                              n_offsets, channels, map4, lowest, s);
    case 4:
      return launch_vec<T, 4>(feats, idx, out, batch, n_rows, m_rows,
                              n_offsets, channels, map4, lowest, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_vec<T, 2>(feats, idx, out, batch, n_rows, m_rows,
                                n_offsets, channels, map4, lowest, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// feats [B, N, C]; idx [B, M, K] int32 in [0, N]; out [B, M, C] in the feats
// dtype (dtype 0 = float32, 1 = bfloat16). `vector_bytes` (16, 8, 4, or 2
// in bf16) of channels a thread, which must divide a row of C channels and
// align feats and out; `map_vector` 4 reads the map by int4 (K % 4 == 0 and
// idx 16-byte aligned), 1 entry by entry. Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int fcaf3d_gather_max_vec(const void* feats, const int32_t* idx,
                                     void* out, int64_t batch, int64_t n_rows,
                                     int64_t m_rows, int64_t n_offsets,
                                     int64_t channels, int dtype,
                                     int vector_bytes, int map_vector,
                                     float lowest, void* stream) {
  const int64_t elt = dtype == 0 ? 4 : 2;
  const bool map4 = map_vector == 4;
  if ((dtype != 0 && dtype != 1) || n_offsets > INT32_MAX ||
      (vector_bytes != 16 && vector_bytes != 8 && vector_bytes != 4 &&
       vector_bytes != 2) ||
      vector_bytes < elt || channels * elt % vector_bytes != 0 ||
      !aligned(feats, vector_bytes) || !aligned(out, vector_bytes) ||
      (map_vector != 1 && !map4) ||
      (map4 && (n_offsets % 4 != 0 || !aligned(idx, 16))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_vec_t<float>(feats, idx, out, batch, n_rows, m_rows,
                               n_offsets, channels, vector_bytes, map4,
                               lowest, s);
  return launch_vec_t<__nv_bfloat16>(feats, idx, out, batch, n_rows, m_rows,
                                     n_offsets, channels, vector_bytes, map4,
                                     lowest, s);
}
