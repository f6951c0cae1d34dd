// K2 on the CUDA cores: the float32 sparse-convolution gather-GEMM with the
// folded inference epilogue (and bfloat16 at shapes the tensor-core kernels
// do not take),
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
// What bounds it on the H100: 2 * hits * C * E float FMAs on the CUDA cores
// (67 TFLOP/s) against one read of feats, the map and W and one write of
// out. The wide convs (C >= 64) are bound by operations; the narrow ones
// (the prune-score conv C1 E8, the f32 stem C3 E64) by the latency of the
// gathered rows, a few bytes each.
//
// Rounding, the same in both variants and at every tile, so a shape's
// result does not depend on its launch: `part` is an fmaf chain over the
// offsets in index order and the channels in order within an offset,
// starting from zero at each of the plain version's three offset chunks
// (closed at k == chunk1 and chunk2, hit or not); `total` adds the chunks
// in order with __fadd_rn, and the epilogue rounds its multiply and adds
// separately. A miss row or a zero-padded channel is skipped or multiplies
// zeros, which leaves the value of `part` unchanged.
//
// Two variants, picked by the wrapper from (C, E, K, dtype) alone:
//
// - Narrow (C < 16): one thread computes one output row for NE (8 or 16)
//   output channels of the block's channel group. W's [K, C, NE] slice sits
//   in shared memory (864 bytes for the prune-score conv, 5 KB for the stem
//   by 16 channels), read as broadcast float4s. The thread reads KB map
//   entries of its row, then the C channels of each hit row, all loads in
//   flight at once, before the FMAs: two to four round trips a row instead of
//   one per offset, no tile padding and no block barrier after W's load.
// - Tiled (C >= 16): one block per (sample, BM output rows, 64 output
//   channels), BM 128 (256 threads) or 64 (128 threads), each thread 8 rows
//   x 4 channels in registers. The block copies its [BM, K] slice of the map
//   into shared memory and lists the offsets with at least one hit. The main
//   loop runs over (offset with a hit) x (32-channel slice of C): the BM
//   gathered rows come in by cp.async (16 bytes, 4 channels, where C % 4 ==
//   0; a miss zero-filled without a read) and W[k]'s [32, 64] slice too,
//   into a three-stage ring, so the loads of the next two steps are in
//   flight during this step's FMAs. Per 4 channels a thread reads a float4
//   of each of its 8 rows and 4 of W for 128 FMAs. Where the tiles would
//   not fill the SMs (the stride-64 convs at batch 1), the offsets are
//   split into the plain version's three chunks, each in blocks of its own
//   writing float32 partials, and a second kernel adds the chunks in order
//   (((0 + p0) + p1) + p2, the order of `total`) and runs the epilogue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "elementwise.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kNarrowThreads = 128;  // rows a block (narrow)
constexpr int kDepth = 32;   // input channels a stage (tiled)
constexpr int kStages = 3;   // cp.async ring depth (tiled)
constexpr int kTM = 8;       // output rows a thread (tiled)
constexpr int kTN = 4;       // output channels a thread (tiled)
constexpr int kBN = 64;      // output channels a block (tiled)
constexpr int kMaxSplit = 3;  // offset chunks of the split tiled variant

struct Epilogue {
  const float* scale;  // null: no epilogue
  const float* shift;
  const void* add;     // [B, M, E] in the feats dtype, or null
  const uint8_t* vmask;
  int act;
};

// The epilogue of output y at flat row `row` (= b * M + m), channel e:
// separately rounded multiply and adds.
template <typename T>
__device__ __forceinline__ float epilogue(float y, int e, int64_t row,
                                          const Epilogue& ep,
                                          int out_channels) {
  if (ep.scale == nullptr) return y;
  const float vm = ep.vmask != nullptr ? (float)ep.vmask[row] : 1.f;
  y = __fadd_rn(__fmul_rn(y, ep.scale[e]), ep.shift[e]);
  if (ep.add != nullptr)
    y = __fadd_rn(y, to_float(static_cast<const T*>(
                         ep.add)[row * out_channels + e]));
  return __fmul_rn(epilogue_act(y, ep.act), vm);
}

// ---------------------------------------------------------------- narrow

template <typename T, int CMAX, int NE>
__global__ void __launch_bounds__(kNarrowThreads)
    gather_gemm_narrow_kernel(const T* __restrict__ feats,
                              const int32_t* __restrict__ idx,
                              const T* __restrict__ weight, Epilogue ep,
                              T* __restrict__ out, int n_rows, int m_rows,
                              int n_offsets, int channels, int out_channels,
                              int chunk1, int chunk2) {
  constexpr int KB = 32 / CMAX;  // offsets whose rows are in flight at once
  extern __shared__ __align__(16) float w_s[];  // [K * C, NE]
  const int b = blockIdx.z, e0 = blockIdx.y * NE;
  const int kc = n_offsets * channels;
  for (int i = threadIdx.x; i < kc * NE; i += kNarrowThreads) {
    const int r = i / NE, j = i % NE;
    w_s[i] = e0 + j < out_channels
                 ? to_float(weight[(int64_t)r * out_channels + e0 + j])
                 : 0.f;
  }
  __syncthreads();
  const int m = blockIdx.x * kNarrowThreads + threadIdx.x;
  if (m >= m_rows) return;
  const int64_t row = (int64_t)b * m_rows + m;
  const int32_t* ir = idx + row * n_offsets;
  const T* fb = feats + (int64_t)b * n_rows * channels;

  float total[NE], part[NE];
#pragma unroll
  for (int j = 0; j < NE; ++j) total[j] = part[j] = 0.f;
  for (int k0 = 0; k0 < n_offsets; k0 += KB) {
    int src[KB];
#pragma unroll
    for (int u = 0; u < KB; ++u)
      src[u] = k0 + u < n_offsets ? ir[k0 + u] : n_rows;
    float a[KB][CMAX];
#pragma unroll
    for (int u = 0; u < KB; ++u)
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        a[u][c] = c < channels && src[u] < n_rows
                      ? to_float(fb[(int64_t)src[u] * channels + c])
                      : 0.f;
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int k = k0 + u;
      if (k >= n_offsets) break;
      if (k == chunk1 || k == chunk2) {  // close an offset chunk, in order
#pragma unroll
        for (int j = 0; j < NE; ++j) {
          total[j] = __fadd_rn(total[j], part[j]);
          part[j] = 0.f;
        }
      }
      if (src[u] >= n_rows) continue;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c >= channels) break;
        const float4* w =
            reinterpret_cast<const float4*>(w_s + (k * channels + c) * NE);
#pragma unroll
        for (int j4 = 0; j4 < NE / 4; ++j4) {
          const float4 wv = w[j4];
          part[4 * j4] = fmaf(a[u][c], wv.x, part[4 * j4]);
          part[4 * j4 + 1] = fmaf(a[u][c], wv.y, part[4 * j4 + 1]);
          part[4 * j4 + 2] = fmaf(a[u][c], wv.z, part[4 * j4 + 2]);
          part[4 * j4 + 3] = fmaf(a[u][c], wv.w, part[4 * j4 + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int e = e0 + j;
    if (e >= out_channels) break;
    const float y = __fadd_rn(total[j], part[j]);
    out[row * out_channels + e] =
        from_float<T>(epilogue<T>(y, e, row, ep, out_channels));
  }
}

// ----------------------------------------------------------------- tiled

template <int BM>
struct Tiled {
  static constexpr int kThreads = (BM / kTM) * (kBN / kTN);
  static constexpr int kRowStep = BM / kTM;  // a thread's rows: ty + i * this
  static constexpr int kAS = kDepth + 4;  // A tile [BM, kDepth] row stride
  static constexpr int kStage = BM * kAS + kDepth * kBN;  // floats
};

template <int BM>
int tiled_smem_bytes(int n_offsets) {
  return kStages * Tiled<BM>::kStage * (int)sizeof(float) +
         (BM + 1) * n_offsets * (int)sizeof(int);
}

// 4 bytes from global to shared memory, asynchronously; zero-filled without
// a read when `valid` is false.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// One element of a stage: float32 by cp.async, bfloat16 converted through
// registers (the bf16 shapes that come here are off every main path).
template <typename T>
__device__ __forceinline__ void stage_put(float* dst, const T* src,
                                          bool valid) {
  if constexpr (std::is_same<T, float>::value) {
    cp_async4(dst, src, valid);
  } else {
    *dst = valid ? to_float(*src) : 0.f;
  }
}

// VEC: float32 with C % 4 == 0, E % 4 == 0 and 16-byte aligned feats and
// weight, staged by 16-byte cp.async (4 channels); else element by element.
template <typename T, int BM, bool VEC>
__global__ void __launch_bounds__(Tiled<BM>::kThreads)
    gather_gemm_tiled_kernel(const T* __restrict__ feats,
                             const int32_t* __restrict__ idx,
                             const T* __restrict__ weight, Epilogue ep,
                             T* __restrict__ out, float* __restrict__ part_out,
                             int n_rows, int m_rows, int n_offsets,
                             int channels, int out_channels, int n_split,
                             int chunk1, int chunk2) {
  using P = Tiled<BM>;
  constexpr int kThreads = P::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  int* rows = reinterpret_cast<int*>(stages + kStages * P::kStage);
  int* offs = rows + BM * n_offsets;  // hit flags, then the list of offsets
  __shared__ int n_hit;

  // split: blockIdx.z = b * n_split + offset chunk, the chunks [0, chunk1),
  // [chunk1, chunk2), [chunk2, K) of the plain version
  const int b = blockIdx.z / n_split, chunk = blockIdx.z % n_split;
  const int k_lo = chunk == 0 ? 0 : chunk == 1 ? chunk1 : chunk2;
  const int k_hi = n_split == 1 || chunk == 2 ? n_offsets
                   : chunk == 0               ? chunk1
                                              : chunk2;
  const int m0 = blockIdx.y * BM;
  const int e0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const T* fb = feats + (int64_t)b * n_rows * channels;

  // the block's [BM, K] slice of the map (contiguous); rows past M miss
  for (int k = tid; k < n_offsets; k += kThreads) offs[k] = 0;
  __syncthreads();
  const int64_t base = ((int64_t)b * m_rows + m0) * n_offsets;
  const int n_entries = min(BM, m_rows - m0) * n_offsets;
  for (int i = tid; i < BM * n_offsets; i += kThreads) {
    const int r = i < n_entries ? idx[base + i] : n_rows;
    rows[i] = r;
    const int k = i % n_offsets;
    if (r < n_rows && k >= k_lo && k < k_hi) offs[k] = 1;
  }
  __syncthreads();
  if (tid == 0) {  // compact the flags into the offsets with a hit, in order
    int n = 0;
    for (int k = 0; k < n_offsets; ++k)
      if (offs[k]) offs[n++] = k;
    n_hit = n;
  }
  __syncthreads();
  const int n_slices = (channels + kDepth - 1) / kDepth;
  const int iters = n_hit * n_slices;

  // step t: offset offs[t / n_slices], channels c0 .. c0 + kDepth - 1, into
  // A [BM, kDepth] (row-major) and W [kDepth, kBN]
  auto load = [&](int t) {
    const int k = offs[t / n_slices], c0 = (t % n_slices) * kDepth;
    float* a = stages + (t % kStages) * P::kStage;
    float* w = a + BM * P::kAS;
    if constexpr (VEC) {
      for (int i = tid; i < BM * (kDepth / 4); i += kThreads) {
        const int r = i / (kDepth / 4), c = (i % (kDepth / 4)) * 4;
        const int src = rows[r * n_offsets + k];
        const bool ok = src < n_rows && c0 + c < channels;
        tc::cp_async16(a + r * P::kAS + c,
                       ok ? fb + (int64_t)src * channels + c0 + c : fb, ok);
      }
      for (int i = tid; i < kDepth * (kBN / 4); i += kThreads) {
        const int c = i / (kBN / 4), e = (i % (kBN / 4)) * 4;
        const bool ok = c0 + c < channels && e0 + e < out_channels;
        tc::cp_async16(w + c * kBN + e,
                       ok ? weight + ((int64_t)k * channels + c0 + c) *
                                         out_channels + e0 + e
                          : weight,
                       ok);
      }
    } else {
      for (int i = tid; i < BM * kDepth; i += kThreads) {
        const int r = i / kDepth, c = i % kDepth;
        const int src = rows[r * n_offsets + k];
        const bool ok = src < n_rows && c0 + c < channels;
        stage_put<T>(a + r * P::kAS + c,
                     ok ? fb + (int64_t)src * channels + c0 + c : fb, ok);
      }
      for (int i = tid; i < kDepth * kBN; i += kThreads) {
        const int c = i / kBN, e = i % kBN;
        const bool ok = c0 + c < channels && e0 + e < out_channels;
        stage_put<T>(w + c * kBN + e,
                     ok ? weight + ((int64_t)k * channels + c0 + c) *
                                       out_channels + e0 + e
                        : weight,
                     ok);
      }
    }
  };

  float total[kTM][kTN], part[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) total[i][j] = part[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load(s);
    tc::cp_async_commit();
  }
  int prev = -1;  // the offset of the last step
  for (int t = 0; t < iters; ++t) {
    tc::cp_async_wait<kStages - 2>();  // step t has landed
    __syncthreads();  // ... for every thread, and step t - 1 is consumed
    if (t + kStages - 1 < iters) load(t + kStages - 1);
    tc::cp_async_commit();
    if (t % n_slices == 0) {
      // close the offset chunks passed since the last offset with a hit
      // (the rounding above: closed at chunk1 and chunk2, hit or not)
      const int k = offs[t / n_slices];
      if ((prev < chunk1 && chunk1 <= k) || (prev < chunk2 && chunk2 <= k)) {
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            total[i][j] = __fadd_rn(total[i][j], part[i][j]);
            part[i][j] = 0.f;
          }
      }
      prev = k;
    }
    const float* a = stages + (t % kStages) * P::kStage + ty * P::kAS;
    const float* w = stages + (t % kStages) * P::kStage + BM * P::kAS +
                     tx * kTN;
    // 4 channels at a time: a thread's 8 rows as float4s over the channels,
    // then W's 4 rows; every product in channel order
#pragma unroll 2
    for (int kk = 0; kk < kDepth; kk += 4) {
      float4 av[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            a + i * P::kRowStep * P::kAS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 wv = *reinterpret_cast<const float4*>(w + (kk + u) * kBN);
        const float wa[kTN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float x = u == 0 ? av[i].x : u == 1 ? av[i].y
                          : u == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < kTN; ++j) part[i][j] = fmaf(x, wa[j], part[i][j]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  // split: this chunk's sums go to part_out [n_split, B, M, E] unfinished
  float* chunk_part =
      part_out == nullptr
          ? nullptr
          : part_out + (int64_t)chunk * (gridDim.z / n_split) * m_rows *
                           out_channels;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty + i * P::kRowStep;
    if (m >= m_rows) continue;
    const int64_t row = (int64_t)b * m_rows + m;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int e = e0 + tx * kTN + j;
      if (e >= out_channels) continue;
      const float y = __fadd_rn(total[i][j], part[i][j]);
      if (chunk_part != nullptr) {
        chunk_part[row * out_channels + e] = y;
      } else {
        out[row * out_channels + e] =
            from_float<T>(epilogue<T>(y, e, row, ep, out_channels));
      }
    }
  }
}

// The split variant's second pass: out = epilogue((p0 + p1) + p2), the
// chunks added in order; one thread an output element.
template <typename T>
__global__ void split_sum_kernel(const float* __restrict__ part, Epilogue ep,
                                 T* __restrict__ out, int64_t size,
                                 int out_channels, int n_split) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= size) return;
  float y = part[i];
  for (int s = 1; s < n_split; ++s) y = __fadd_rn(y, part[s * size + i]);
  out[i] = from_float<T>(epilogue<T>(y, (int)(i % out_channels),
                                     i / out_channels, ep, out_channels));
}

// ---------------------------------------------------------------- launch

struct Args {
  const void* feats;
  const int32_t* idx;
  const void* weight;
  Epilogue ep;
  void* out;
  float* part;
  int64_t batch, n_rows, m_rows, n_offsets, channels, out_channels;
  int64_t chunk1, chunk2;
  int n_split;
  cudaStream_t stream;
};

template <typename T, int CMAX, int NE>
int launch_narrow(const Args& a) {
  static int granted = 0;
  auto kernel = gather_gemm_narrow_kernel<T, CMAX, NE>;
  const int smem = (int)(a.n_offsets * a.channels * NE * sizeof(float));
  int err = tc::allow_smem(kernel, smem, granted);
  if (err != 0) return err;
  const dim3 grid((unsigned)((a.m_rows + kNarrowThreads - 1) / kNarrowThreads),
                  (unsigned)((a.out_channels + NE - 1) / NE),
                  (unsigned)a.batch);
  kernel<<<grid, kNarrowThreads, smem, a.stream>>>(
      (const T*)a.feats, a.idx, (const T*)a.weight, a.ep, (T*)a.out,
      (int)a.n_rows, (int)a.m_rows, (int)a.n_offsets, (int)a.channels,
      (int)a.out_channels, (int)a.chunk1, (int)a.chunk2);
  return (int)cudaGetLastError();
}

// The narrow instance for C channels (CMAX the next of 1, 4, 16) and NE.
template <typename T, int NE>
int launch_narrow_c(const Args& a) {
  if (a.channels == 1) return launch_narrow<T, 1, NE>(a);
  if (a.channels <= 4) return launch_narrow<T, 4, NE>(a);
  return launch_narrow<T, 16, NE>(a);
}

template <typename T, int BM, bool VEC>
int launch_tiled(const Args& a) {
  static int granted = 0;
  auto kernel = gather_gemm_tiled_kernel<T, BM, VEC>;
  const int smem = tiled_smem_bytes<BM>((int)a.n_offsets);
  int err = tc::allow_smem(kernel, smem, granted);
  if (err != 0) return err;
  const dim3 grid((unsigned)((a.out_channels + kBN - 1) / kBN),
                  (unsigned)((a.m_rows + BM - 1) / BM),
                  (unsigned)(a.batch * a.n_split));
  kernel<<<grid, Tiled<BM>::kThreads, smem, a.stream>>>(
      (const T*)a.feats, a.idx, (const T*)a.weight, a.ep, (T*)a.out,
      a.n_split > 1 ? a.part : nullptr, (int)a.n_rows, (int)a.m_rows,
      (int)a.n_offsets, (int)a.channels, (int)a.out_channels, a.n_split,
      (int)a.chunk1, (int)a.chunk2);
  err = (int)cudaGetLastError();
  if (err != 0 || a.n_split == 1) return err;
  constexpr int kSumThreads = 256;
  const int64_t size = a.batch * a.m_rows * a.out_channels;
  split_sum_kernel<T><<<(unsigned)((size + kSumThreads - 1) / kSumThreads),
                        kSumThreads, 0, a.stream>>>(
      a.part, a.ep, (T*)a.out, size, (int)a.out_channels, a.n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int variant, int tile_m, int tile_n) {
  if (variant == 1 && a.n_split == 1 && a.channels < 16 &&
      tile_m == kNarrowThreads) {
    if (tile_n == 8) return launch_narrow_c<T, 8>(a);
    if (tile_n == 16) return launch_narrow_c<T, 16>(a);
  }
  if (variant == 2 && tile_n == kBN) {
    const bool vec = std::is_same<T, float>::value && a.channels % 4 == 0 &&
                     a.out_channels % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a.feats) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.weight) % 16 == 0;
    if (tile_m == 128)
      return vec ? launch_tiled<T, 128, true>(a) : launch_tiled<T, 128, false>(a);
    if (tile_m == 64)
      return vec ? launch_tiled<T, 64, true>(a) : launch_tiled<T, 64, false>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// feats [B, N, C]; idx [B, M, K] int32 in [0, N]; weight [K, C, E]; out
// [B, M, E], all in one dtype (0 = float32, 1 = bfloat16). scale/shift [E]
// float32 or both null (then add and vmask must be null too); add [B, M, E]
// in the feats dtype or null; vmask [B, M] uint8 or null. chunk1 <= chunk2
// split the offsets into the three summation chunks. act: 0 none, 1 relu,
// 2 elu. variant 1 (narrow: C < 16) with tile (128 rows, 8 or 16
// channels); variant 2 (tiled) with tile (128 or 64 rows, 64 channels),
// where n_split 3 sums the offset chunks [0, chunk1), [chunk1, chunk2),
// [chunk2, K) in blocks of their own into part, float32 [3, B, M, E], then
// adds them in order before the epilogue; n_split 1 needs no part. Returns
// the first non-zero cudaError_t of the launches, or cudaErrorInvalidValue
// for a combination it does not take.
extern "C" int fcaf3d_gather_gemm_simt(
    const void* feats, const int32_t* idx, const void* weight,
    const float* scale, const float* shift, const void* add,
    const uint8_t* vmask, void* out, float* part, int64_t batch,
    int64_t n_rows, int64_t m_rows, int64_t n_offsets, int64_t channels,
    int64_t out_channels, int64_t chunk1, int64_t chunk2, int dtype, int act,
    int variant, int tile_m, int tile_n, int n_split, void* stream) {
  if (batch == 0 || m_rows == 0 || out_channels == 0) return 0;
  if (n_offsets <= 0 || channels <= 0 || batch * n_split > 65535 ||
      !(n_split == 1 || n_split == kMaxSplit) ||
      !(0 <= chunk1 && chunk1 <= chunk2 && chunk2 <= n_offsets) ||
      (n_split > 1 && (variant != 2 || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{feats,    idx,   weight, Epilogue{scale, shift, add, vmask, act},
               out,      part,  batch,  n_rows, m_rows, n_offsets, channels,
               out_channels, chunk1, chunk2, n_split, (cudaStream_t)stream};
  if (dtype == 0) return dispatch<float>(a, variant, tile_m, tile_n);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, variant, tile_m, tile_n);
  return (int)cudaErrorInvalidValue;
}
