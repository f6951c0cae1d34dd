// K2 on the tensor cores: the bf16 sparse-convolution gather-GEMM with the
// folded inference epilogue,
//
//   out[b, m] = act(sum_k feats[b, idx[b, m, k]] @ W[k] * scale + shift
//                   [+ add[b, m]]) * vmask[b, m]
//
// in bfloat16 with float32 accumulators. A miss (idx == N) adds zero;
// without `scale` there is no epilogue at all. The same function as the
// SIMT kernel of `gather_gemm.cu`, which keeps the float32 variant.
//
// Replaces the TPU kernel fcaf3d_tpu/ops/sparse/gather_kernel.py::
// _fused_pallas (entry fused_gather_gemm), which DMAs a window of input rows
// per output tile and selects rows with one-hot matmuls on the MXU (bf16
// operands, float32 accumulation).
//
// What bounds it on the H100: 2 * hits * C * E FLOPs against one read of
// feats, the map and W and one write of out. On the real maps that is about
// 200 FLOPs per byte at C = E = 64 and more at the wider convs: near or
// above the bf16 tensor cores' ridge (~295), so operations bound it, and
// what a kernel has to hide is the latency of the gathered rows (each a
// random 16-1024-byte read).
//
// Design. Two variants, picked by the wrapper from (C, E, K) alone:
//
// - Generic (C % 8 == 0): one block per (sample, BM output rows, BN output
//   channels), 4 or 8 warps, each holding a grid of m16n8 accumulators.
//   The block copies its [BM, K] slice of the map into shared memory (one
//   contiguous read) and lists the offsets with at least one hit. The main
//   loop runs over (offset with a hit) x (32-channel slice of C): the BM
//   gathered rows come in by cp.async, 16 bytes (8 channels) a thread, a
//   miss row zero-filled without a read, and W[k]'s [32, BN] tile too, into
//   a three-stage ring, so the loads of the next two stages overlap this
//   stage's MMAs. Fragments come from ldmatrix (W's [C, E] tile
//   transposed), the product from mma.sync m16n8k16 bf16 -> f32. Where
//   the tiles would not fill the SMs (the stride-64 convs: M = 1 024), the
//   offsets are split into the plain version's three chunks, each in blocks
//   of its own writing float32 partials; a second kernel adds the chunks in
//   order and runs the epilogue (which is not distributive) on the sum.
// - Folded (C < 16, the stem and the prune-score conv): one A row is the
//   concatenation over k of feats[idx[m, k]] (K * C values, zero for
//   misses), padded to a multiple of 16; B is W viewed as [K * C, E]. One
//   pass of MMAs over that depth, with plain loads for A (a row of C < 8
//   channels is below cp.async's 16-byte granule): one thread per (row,
//   offset), four map reads in flight before their rows are read.
//
// Offsets are summed in one float32 accumulator, in index order (in each
// chunk when split); the
// epilogue runs on the accumulators, in float, with separately rounded
// multiply and add as in the plain version, and stores bfloat16 pairs.
// E must be a multiple of 8; rows and channels are masked at M and E.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;

constexpr int kStages = 3;   // cp.async ring depth (generic variant)
constexpr int kDepth = 32;   // input channels per stage (two k16 steps)
constexpr int kMaxFold = 512;  // largest K * C padded depth of the folded variant
constexpr int kInFlight = 4;  // (row, offset) pairs a thread gathers at once
constexpr int kMaxSplit = 3;  // offset chunks of the split generic variant

enum Act { kNone = 0, kRelu = 1, kElu = 2 };

struct Epilogue {
  const float* scale;  // null: no epilogue
  const float* shift;
  const bf16* add;
  const uint8_t* vmask;
  int act;
};

// The epilogue of one output value y of channel e, row `row` (flat b * M +
// m) whose vmask is vm, in float with separately rounded multiply and add.
__device__ __forceinline__ float epilogue(float y, int e, int64_t row,
                                          float vm, const Epilogue& ep,
                                          int out_channels) {
  if (ep.scale == nullptr) return y;
  y = __fadd_rn(__fmul_rn(y, ep.scale[e]), ep.shift[e]);
  if (ep.add != nullptr)
    y = __fadd_rn(y, __bfloat162float(ep.add[row * out_channels + e]));
  if (ep.act == kRelu) {
    y = fmaxf(y, 0.f);
  } else if (ep.act == kElu) {
    y = y > 0.f ? y : __fsub_rn(expf(fminf(y, 0.f)), 1.f);
  }
  return __fmul_rn(y, vm);
}

// Epilogue and store of a warp's MT x NT m16n8 accumulator tiles, whose
// corner is output row m_first of sample row block `row_base` (= b * M) and
// channel e_first. With `part` (the split variant) the float sums go there,
// [B * M, E] of this offset chunk, without the epilogue.
template <int MT, int NT>
__device__ __forceinline__ void store_tiles(const float (&acc)[MT][NT][4],
                                            const Epilogue& ep,
                                            bf16* __restrict__ out,
                                            float* __restrict__ part,
                                            int64_t row_base, int m_first,
                                            int m_rows, int e_first,
                                            int out_channels, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_first + mt * 16 + lane / 4 + h * 8;
      if (m >= m_rows) continue;
      const int64_t row = row_base + m;
      const float vm = ep.vmask != nullptr ? (float)ep.vmask[row] : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int e = e_first + nt * 8 + (lane % 4) * 2;
        if (e >= out_channels) continue;  // E % 8 == 0: e + 1 < E as well
        const float y0 = acc[mt][nt][2 * h], y1 = acc[mt][nt][2 * h + 1];
        if (part != nullptr) {
          *reinterpret_cast<float2*>(part + row * out_channels + e) =
              make_float2(y0, y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + row * out_channels + e) =
              __floats2bfloat162_rn(
                  epilogue(y0, e, row, vm, ep, out_channels),
                  epilogue(y1, e + 1, row, vm, ep, out_channels));
        }
      }
    }
  }
}

template <int BM, int BN, int WM, int WN>
__host__ __device__ constexpr int threads_of() {
  return (BM / WM) * (BN / WN) * 32;
}

// Dynamic shared memory of the generic variant: the stage ring, the
// block's map slice [BM, K] and the offset list [K].
template <int BM, int BN>
__host__ __device__ constexpr int generic_stage_elems() {
  return BM * tc::smem_stride(kDepth) + kDepth * tc::smem_stride(BN);
}

template <int BM, int BN>
int generic_smem_bytes(int n_offsets) {
  return kStages * generic_stage_elems<BM, BN>() * (int)sizeof(bf16) +
         (BM + 1) * n_offsets * (int)sizeof(int);
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
    gather_gemm_tc_kernel(const bf16* __restrict__ feats,
                          const int32_t* __restrict__ idx,
                          const bf16* __restrict__ weight, Epilogue ep,
                          bf16* __restrict__ out, float* __restrict__ part,
                          int n_rows, int m_rows, int n_offsets, int channels,
                          int out_channels, int n_split, int chunk1,
                          int chunk2) {
  constexpr int kThreads = threads_of<BM, BN, WM, WN>();
  constexpr int kWarpsN = BN / WN;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int AS = tc::smem_stride(kDepth), BS = tc::smem_stride(BN);
  constexpr int kStageElems = generic_stage_elems<BM, BN>();
  constexpr int kChunksA = kDepth / 8, kChunksB = BN / 8;  // 16 B per row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  int* rows = reinterpret_cast<int*>(stages + kStages * kStageElems);
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
  const int e0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / kWarpsN) * WM, wn = (warp % kWarpsN) * WN;
  const bf16* fb = feats + (int64_t)b * n_rows * channels;

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

  // stage t: offset offs[t / n_slices], channels c0 .. c0 + 31
  auto load = [&](int t) {
    const int k = offs[t / n_slices], c0 = (t % n_slices) * kDepth;
    bf16* a = stages + (t % kStages) * kStageElems;
    bf16* w = a + BM * AS;
    for (int i = tid; i < BM * kChunksA; i += kThreads) {
      const int r = i / kChunksA, j = (i % kChunksA) * 8;
      const int src = rows[r * n_offsets + k];
      const bool ok = src < n_rows && c0 + j < channels;
      tc::cp_async16(a + r * AS + j,
                     ok ? fb + (int64_t)src * channels + c0 + j : fb, ok);
    }
    for (int i = tid; i < kDepth * kChunksB; i += kThreads) {
      const int r = i / kChunksB, j = (i % kChunksB) * 8;
      const bool ok = c0 + r < channels && e0 + j < out_channels;
      tc::cp_async16(w + r * BS + j,
                     ok ? weight + ((int64_t)k * channels + c0 + r) *
                                       out_channels + e0 + j
                        : weight,
                     ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load(s);
    tc::cp_async_commit();
  }
  for (int t = 0; t < iters; ++t) {
    tc::cp_async_wait<kStages - 2>();  // stage t has landed
    __syncthreads();  // ... for every thread, and stage t - 1 is consumed
    if (t + kStages - 1 < iters) load(t + kStages - 1);
    tc::cp_async_commit();
    const bf16* a = stages + (t % kStages) * kStageElems;
    const bf16* w = a + BM * AS;
#pragma unroll
    for (int k0 = 0; k0 < kDepth; k0 += 16)
      tc::warp_mma_k16<MT, NT, false>(acc, a, AS, w, BS, wm, wn, k0, lane);
  }
  tc::cp_async_wait<0>();
  float* chunk_part =
      part == nullptr
          ? nullptr
          : part + (int64_t)chunk * (gridDim.z / n_split) * m_rows *
                       out_channels;
  store_tiles<MT, NT>(acc, ep, out, chunk_part, (int64_t)b * m_rows, m0 + wm,
                      m_rows, e0 + wn, out_channels, lane);
}

// The split variant's second pass: out = epilogue(part[0] + part[1] +
// part[2]), the chunks added in order; one thread per pair of channels.
__global__ void split_sum_kernel(const float* __restrict__ part, Epilogue ep,
                                 bf16* __restrict__ out, int64_t rows,
                                 int out_channels, int n_split) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t pairs = rows * out_channels / 2;
  if (i >= pairs) return;
  const int64_t row = i / (out_channels / 2);
  const int e = (int)(i % (out_channels / 2)) * 2;
  const float vm = ep.vmask != nullptr ? (float)ep.vmask[row] : 1.f;
  float2 y = reinterpret_cast<const float2*>(part)[i];
  for (int s = 1; s < n_split; ++s) {
    const float2 p = reinterpret_cast<const float2*>(part)[s * pairs + i];
    y.x = __fadd_rn(y.x, p.x);
    y.y = __fadd_rn(y.y, p.y);
  }
  reinterpret_cast<__nv_bfloat162*>(out)[i] = __floats2bfloat162_rn(
      epilogue(y.x, e, row, vm, ep, out_channels),
      epilogue(y.y, e + 1, row, vm, ep, out_channels));
}

template <int BN>
int folded_smem_bytes(int depth, int bm) {
  return (bm * (depth + 8) + depth * tc::smem_stride(BN)) * (int)sizeof(bf16);
}

// `depth` = K * C rounded up to a multiple of 16 (so depth + 8 is an odd
// number of 16-byte units: no ldmatrix bank conflicts).
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
    gather_gemm_folded_kernel(const bf16* __restrict__ feats,
                              const int32_t* __restrict__ idx,
                              const bf16* __restrict__ weight, Epilogue ep,
                              bf16* __restrict__ out, int n_rows, int m_rows,
                              int n_offsets, int channels, int out_channels,
                              int depth) {
  constexpr int kThreads = threads_of<BM, BN, WM, WN>();
  constexpr int kWarpsN = BN / WN;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int BS = tc::smem_stride(BN);
  constexpr int kChunksB = BN / 8;
  const int as = depth + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);
  bf16* w = a + BM * as;

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int e0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / kWarpsN) * WM, wn = (warp % kWarpsN) * WN;
  const int kc = n_offsets * channels;
  const bf16* fb = feats + (int64_t)b * n_rows * channels;

  // B: W viewed as [K * C, E]; rows past K * C are zero
  for (int i = tid; i < depth * kChunksB; i += kThreads) {
    const int r = i / kChunksB, j = (i % kChunksB) * 8;
    const bool ok = r < kc && e0 + j < out_channels;
    tc::cp_async16(w + r * BS + j,
                   ok ? weight + (int64_t)r * out_channels + e0 + j : weight,
                   ok);
  }
  tc::cp_async_commit();
  // A: row m is feats[idx[m, k]] for k in order, C channels each: one
  // (row, offset) pair a thread, kInFlight pairs' map reads in flight (the
  // block's [BM, K] slice of the map is contiguous), then their C channels;
  // misses and rows past M are zero, and so are the columns past K * C
  const int64_t base = ((int64_t)b * m_rows + m0) * n_offsets;
  const int n_pairs = BM * n_offsets;
  const int n_entries = min(BM, m_rows - m0) * n_offsets;
  for (int i0 = tid; i0 < n_pairs; i0 += kInFlight * kThreads) {
    int src[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kThreads;
      src[u] = i < n_entries ? idx[base + i] : n_rows;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n_pairs) continue;
      const int r = i / n_offsets;
      bf16* dst = a + r * as + (i - r * n_offsets) * channels;
      const bf16* row = fb + (int64_t)src[u] * channels;
      for (int c = 0; c < channels; ++c)
        dst[c] = src[u] < n_rows ? row[c] : __float2bfloat16(0.f);
    }
  }
  for (int i = tid; i < BM * (depth - kc); i += kThreads)
    a[(i / (depth - kc)) * as + kc + i % (depth - kc)] = __float2bfloat16(0.f);
  tc::cp_async_wait<0>();
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
  for (int k0 = 0; k0 < depth; k0 += 16)
    tc::warp_mma_k16<MT, NT, false>(acc, a, as, w, BS, wm, wn, k0, lane);
  store_tiles<MT, NT>(acc, ep, out, nullptr, (int64_t)b * m_rows, m0 + wm,
                      m_rows, e0 + wn, out_channels, lane);
}

// Kernel, block size and dynamic shared memory of one (variant, tile).
template <int BM, int BN, int WM, int WN>
int launch_generic(const bf16* feats, const int32_t* idx, const bf16* weight,
                   const Epilogue& ep, bf16* out, float* part, int64_t batch,
                   int64_t n_rows, int64_t m_rows, int64_t n_offsets,
                   int64_t channels, int64_t out_channels, int n_split,
                   int64_t chunk1, int64_t chunk2, cudaStream_t stream) {
  static int granted = 0;
  auto kernel = gather_gemm_tc_kernel<BM, BN, WM, WN>;
  const int smem = generic_smem_bytes<BM, BN>((int)n_offsets);
  int err = tc::allow_smem(kernel, smem, granted);
  if (err != 0) return err;
  const dim3 grid((unsigned)((out_channels + BN - 1) / BN),
                  (unsigned)((m_rows + BM - 1) / BM),
                  (unsigned)(batch * n_split));
  kernel<<<grid, threads_of<BM, BN, WM, WN>(), smem, stream>>>(
      feats, idx, weight, ep, out, n_split > 1 ? part : nullptr, (int)n_rows,
      (int)m_rows, (int)n_offsets, (int)channels, (int)out_channels, n_split,
      (int)chunk1, (int)chunk2);
  err = (int)cudaGetLastError();
  if (err != 0 || n_split == 1) return err;
  constexpr int kSumThreads = 256;
  const int64_t pairs = batch * m_rows * out_channels / 2;
  split_sum_kernel<<<(unsigned)((pairs + kSumThreads - 1) / kSumThreads),
                     kSumThreads, 0, stream>>>(part, ep, out, batch * m_rows,
                                               (int)out_channels, n_split);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int WM, int WN>
int launch_folded(const bf16* feats, const int32_t* idx, const bf16* weight,
                  const Epilogue& ep, bf16* out, int64_t batch,
                  int64_t n_rows, int64_t m_rows, int64_t n_offsets,
                  int64_t channels, int64_t out_channels,
                  cudaStream_t stream) {
  static int granted = 0;
  auto kernel = gather_gemm_folded_kernel<BM, BN, WM, WN>;
  const int depth = (int)((n_offsets * channels + 15) / 16 * 16);
  const int smem = folded_smem_bytes<BN>(depth, BM);
  int err = tc::allow_smem(kernel, smem, granted);
  if (err != 0) return err;
  const dim3 grid((unsigned)((out_channels + BN - 1) / BN),
                  (unsigned)((m_rows + BM - 1) / BM), (unsigned)batch);
  kernel<<<grid, threads_of<BM, BN, WM, WN>(), smem, stream>>>(
      feats, idx, weight, ep, out, (int)n_rows, (int)m_rows, (int)n_offsets,
      (int)channels, (int)out_channels, depth);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 only. feats [B, N, C]; idx [B, M, K] int32 in [0, N]; weight
// [K, C, E]; out [B, M, E]; scale/shift [E] float32 or both null (then add
// and vmask must be null too); add [B, M, E] bfloat16 or null; vmask [B, M]
// uint8 or null. act: 0 none, 1 relu, 2 elu. variant 1 (generic: C % 8 ==
// 0) with tile (128, 128) or (64, 64), or variant 2 (folded: K * C padded to
// 16 at most 512) with tile (64, 64) or (128, 8). n_split 3 (generic only)
// sums the offset chunks [0, chunk1), [chunk1, chunk2), [chunk2, K) in
// blocks of their own into part, float32 [3, B, M, E], then adds them in
// order before the epilogue; n_split 1 needs no part. E % 8 == 0; feats
// (generic variant) and weight 16-byte aligned. Returns the first non-zero
// cudaError_t of the launches, or cudaErrorInvalidValue for a combination
// it does not take.
extern "C" int fcaf3d_gather_gemm_tc(
    const void* feats, const int32_t* idx, const void* weight,
    const float* scale, const float* shift, const void* add,
    const uint8_t* vmask, void* out, float* part, int64_t batch,
    int64_t n_rows, int64_t m_rows, int64_t n_offsets, int64_t channels,
    int64_t out_channels, int act, int variant, int tile_m, int tile_n,
    int n_split, int64_t chunk1, int64_t chunk2, void* stream) {
  if (batch == 0 || m_rows == 0 || out_channels == 0) return 0;
  if (out_channels % 8 != 0 || n_offsets <= 0 ||
      batch * n_split > 65535 || !(n_split == 1 || n_split == kMaxSplit) ||
      (n_split > 1 && (variant != 1 || part == nullptr ||
                       !(0 <= chunk1 && chunk1 <= chunk2 &&
                         chunk2 <= n_offsets))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Epilogue ep{scale, shift, (const bf16*)add, vmask, act};
  const bf16* f = (const bf16*)feats;
  const bf16* w = (const bf16*)weight;
  bf16* o = (bf16*)out;
  if (variant == 1 && channels % 8 == 0) {
    if (tile_m == 128 && tile_n == 128)
      return launch_generic<128, 128, 64, 32>(
          f, idx, w, ep, o, part, batch, n_rows, m_rows, n_offsets, channels,
          out_channels, n_split, chunk1, chunk2, s);
    if (tile_m == 64 && tile_n == 64)
      return launch_generic<64, 64, 32, 32>(
          f, idx, w, ep, o, part, batch, n_rows, m_rows, n_offsets, channels,
          out_channels, n_split, chunk1, chunk2, s);
  }
  if (variant == 2 && n_split == 1 &&
      (n_offsets * channels + 15) / 16 * 16 <= kMaxFold) {
    if (tile_m == 64 && tile_n == 64)
      return launch_folded<64, 64, 32, 32>(f, idx, w, ep, o, batch, n_rows,
                                           m_rows, n_offsets, channels,
                                           out_channels, s);
    if (tile_m == 128 && tile_n == 8)
      return launch_folded<128, 8, 32, 8>(f, idx, w, ep, o, batch, n_rows,
                                          m_rows, n_offsets, channels,
                                          out_channels, s);
  }
  return (int)cudaErrorInvalidValue;
}
