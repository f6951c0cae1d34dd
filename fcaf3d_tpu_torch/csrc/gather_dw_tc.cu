// K4 on the tensor cores: the bf16 weight gradient of the sparse
// convolution's gather-GEMM,
//
//   dW[k] = sum_{b, m} feats[b, idx[b, m, k]]^T (outer) dout[b, m]
//
// with float32 accumulators, [K, C, E] float32. A miss (idx == N) adds
// zero. The same function as the SIMT kernel of `gather_dw.cu`, which keeps
// the float32 variant.
//
// Replaces the TPU kernel fcaf3d_tpu/ops/sparse/gather_kernel.py::
// _fused_dw_pallas (entry fused_gather_dw), which selects window rows with
// one-hot matmuls and keeps a [k_chunk, C, E] output block resident in VMEM
// across a sequential grid.
//
// What bounds it on the H100: 2 * hits * C * E FLOPs against one read of
// feats, the map and dout: operations at the wide convs (bf16 products,
// exact in float32, on the tensor cores), the gathered rows' latency and
// the map's strided reads at the narrow ones.
//
// Design. The MMA's M is a tile of C, its N a tile of E, its depth the rows
// that hit. Blocks run in no order, so nothing is carried between them: one
// block per (E tile, C tile, offset k, slice s of the B * M rows). A block
// walks its slice in rounds of 1024 rows: each warp ballots its rows' hits
// and one warp scans the counts, which lists the round's hit rows, in row
// order, in shared memory (misses cost one read of the map). The hit rows'
// C tile of feats and E tile of dout come in by cp.async, 32 rows a stage,
// into a three-stage ring (the last stage padded with zero rows); fragments
// come from ldmatrix.trans (both operands lie row by row), the products
// from mma.sync m16n8k16 bf16 -> f32.
//
// Folded (C < 16, the stem): dW viewed as [K * C, E] = sum_r G_r^T dout_r,
// where G_r holds row r's K * C gathered values (zero for misses), so one
// block tile of 128 covers every offset; a row is listed when it hits at any
// offset, and its G_r is gathered with plain loads (C < 8 channels is below
// cp.async's 16-byte granule).
//
// Each block writes its partial to part[s, k, c, e]; `sum_slices.cuh` adds
// the slices in slice order, as for the SIMT kernel. No float atomics: a
// repeated backward is bitwise equal. C % 8 == 0 (generic) and E % 8 == 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sum_slices.cuh"
#include "tensor_core.cuh"

namespace {

using tc::bf16;

constexpr int kStages = 3;    // cp.async ring depth
constexpr int kChunk = 32;    // hit rows per stage (two k16 steps)
constexpr int kRound = 1024;  // rows listed per round
constexpr int kFoldRows = 128;  // the folded variant's K * C tile
constexpr int kInFlight = 8;  // (row, offset) pairs a thread gathers at once

template <int TM, int TN, int WM, int WN>
__host__ __device__ constexpr int threads_of() {
  return (TM / WM) * (TN / WN) * 32;
}

template <int TM, int TN>
__host__ __device__ constexpr int stage_elems() {
  return kChunk * (tc::smem_stride(TM) + tc::smem_stride(TN));
}

template <int TM, int TN>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_elems<TM, TN>() * (int)sizeof(bf16) +
         2 * kRound * (int)sizeof(int);
}

template <int TM, int TN, int WM, int WN, bool FOLDED>
__global__ void __launch_bounds__((TM / WM) * (TN / WN) * 32)
    gather_dw_tc_kernel(const bf16* __restrict__ feats,
                        const int32_t* __restrict__ idx,
                        const bf16* __restrict__ dout,
                        float* __restrict__ part, int n_rows, int m_rows,
                        int n_offsets, int channels, int out_channels,
                        int64_t total_rows, int64_t rows_per_slice,
                        int n_slices) {
  constexpr int kThreads = threads_of<TM, TN, WM, WN>();
  constexpr int kWarps = kThreads / 32, kWarpsN = TN / WN;
  constexpr int kPer = kRound / kThreads;  // rows per thread and round
  static_assert(kWarps * kPer == 32, "one count per lane of the scan");
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int AS = tc::smem_stride(TM), DS = tc::smem_stride(TN);
  constexpr int kStageElems = stage_elems<TM, TN>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  // [kRound] b * N + feats row of the p-th hit (folded: a hit flag a row)
  int* hit_feat = reinterpret_cast<int*>(stages + kStages * kStageElems);
  int* hit_row = hit_feat + kRound;  // flat (b, m) row of the p-th hit
  __shared__ int counts[32];
  __shared__ int n_hit;

  const int e0 = blockIdx.x * TN;
  const int c0 = FOLDED ? 0 : blockIdx.y * TM;
  const int k = FOLDED ? 0 : blockIdx.z / n_slices;
  const int s = FOLDED ? blockIdx.z : blockIdx.z % n_slices;
  const int64_t r_begin = (int64_t)s * rows_per_slice;
  const int64_t r_end = min(total_rows, r_begin + rows_per_slice);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / kWarpsN) * WM, wn = (warp % kWarpsN) * WN;
  // rows of the block's dW tile: C, or K * C when folded
  const int kc = FOLDED ? n_offsets * channels : channels;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
  if constexpr (FOLDED) {
    // the A columns past K * C stay zero in every stage: no load writes them
    for (int i = tid; i < kStages * kChunk * (TM - kc); i += kThreads) {
      const int row = i / (TM - kc);  // stage * kChunk + row in the stage
      stages[(row / kChunk) * kStageElems + (row % kChunk) * AS + kc +
             i % (TM - kc)] = __float2bfloat16(0.f);
    }
  }

  for (int64_t q0 = r_begin; q0 < r_end; q0 += kRound) {
    // list the round's rows that hit (offset k; folded: any offset), in
    // row order: rows q0 + i * kThreads + tid, counted per (i, warp)
    const int n_round = (int)min((int64_t)kRound, r_end - q0);
    if constexpr (FOLDED) {
      // flags of the rows with a hit at any offset, from one coalesced
      // read of the round's [rows, K] block of the map
      for (int i = tid; i < kRound; i += kThreads) hit_feat[i] = 0;
      __syncthreads();
      const int32_t* blk = idx + q0 * n_offsets;
#pragma unroll 4
      for (int i = tid; i < n_round * n_offsets; i += kThreads)
        if (blk[i] < n_rows) hit_feat[i / n_offsets] = 1;
      __syncthreads();
    }
    int src[kPer];
    unsigned mask[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int rr = i * kThreads + tid;
      src[i] = n_rows;
      if (rr < n_round) {
        if constexpr (FOLDED) {
          src[i] = hit_feat[rr] ? 0 : n_rows;  // any offset hits
        } else {
          src[i] = idx[(q0 + rr) * n_offsets + k];
        }
      }
      mask[i] = __ballot_sync(0xffffffffu, src[i] < n_rows);
      if (lane == 0) counts[i * kWarps + warp] = __popc(mask[i]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 32 counts
      const int v = counts[lane];
      int x = v;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      counts[lane] = x - v;
      if (lane == 31) n_hit = x;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (src[i] < n_rows) {
        const int64_t r = q0 + i * kThreads + tid;
        const int p = counts[i * kWarps + warp] +
                      __popc(mask[i] & ((1u << lane) - 1u));
        hit_row[p] = (int)r;
        if constexpr (!FOLDED)
          hit_feat[p] = (int)((r / m_rows) * n_rows + src[i]);
      }
    }
    __syncthreads();
    const int hits = n_hit;
    const int chunks = (hits + kChunk - 1) / kChunk;

    // stage q: hit rows 32 q .. 32 q + 31; past the last hit, zero rows
    auto load = [&](int q) {
      bf16* a = stages + (q % kStages) * kStageElems;
      bf16* d = a + kChunk * AS;
      const int p0 = q * kChunk;
      if constexpr (FOLDED) {
        // one (hit row, offset) pair a thread, kInFlight pairs' map reads
        // in flight, then their C channels; misses and rows past the last
        // hit are zero
        const int n_pairs = kChunk * n_offsets;
        for (int i0 = tid; i0 < n_pairs; i0 += kInFlight * kThreads) {
          int sr[kInFlight];
          int64_t base[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            const int i = i0 + u * kThreads, rr = i / n_offsets;
            sr[u] = n_rows;
            base[u] = 0;
            if (i < n_pairs && p0 + rr < hits) {
              const int64_t r = hit_row[p0 + rr];
              sr[u] = idx[r * n_offsets + i - rr * n_offsets];
              base[u] = (r / m_rows) * n_rows;
            }
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            const int i = i0 + u * kThreads, rr = i / n_offsets;
            if (i >= n_pairs) continue;
            bf16* dst = a + rr * AS + (i - rr * n_offsets) * channels;
            const bf16* row = feats + (base[u] + sr[u]) * channels;
            for (int c = 0; c < channels; ++c)
              dst[c] = sr[u] < n_rows ? row[c] : __float2bfloat16(0.f);
          }
        }
      } else {
        constexpr int kChunksA = TM / 8;
        for (int i = tid; i < kChunk * kChunksA; i += kThreads) {
          const int rr = i / kChunksA, j = (i % kChunksA) * 8, p = p0 + rr;
          const bool ok = p < hits && c0 + j < channels;
          tc::cp_async16(
              a + rr * AS + j,
              ok ? feats + (int64_t)hit_feat[p] * channels + c0 + j : feats,
              ok);
        }
      }
      constexpr int kChunksD = TN / 8;
      for (int i = tid; i < kChunk * kChunksD; i += kThreads) {
        const int rr = i / kChunksD, j = (i % kChunksD) * 8, p = p0 + rr;
        const bool ok = p < hits && e0 + j < out_channels;
        tc::cp_async16(
            d + rr * DS + j,
            ok ? dout + (int64_t)hit_row[p] * out_channels + e0 + j : dout,
            ok);
      }
    };

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < chunks) load(st);
      tc::cp_async_commit();
    }
    for (int q = 0; q < chunks; ++q) {
      tc::cp_async_wait<kStages - 2>();  // stage q has landed
      __syncthreads();  // ... for every thread, and stage q - 1 is consumed
      if (q + kStages - 1 < chunks) load(q + kStages - 1);
      tc::cp_async_commit();
      const bf16* a = stages + (q % kStages) * kStageElems;
      const bf16* d = a + kChunk * AS;
#pragma unroll
      for (int k0 = 0; k0 < kChunk; k0 += 16)
        tc::warp_mma_k16<MT, NT, true>(acc, a, AS, d, DS, wm, wn, k0, lane);
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // the next round rewrites the hit list and the ring
  }

  float* dst = part + (int64_t)s * n_offsets * channels * out_channels +
               (int64_t)k * channels * out_channels;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm + mt * 16 + lane / 4 + h * 8;
      if (c >= kc) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int e = e0 + wn + nt * 8 + (lane % 4) * 2;
        if (e >= out_channels) continue;  // E % 8 == 0: e + 1 < E as well
        *reinterpret_cast<float2*>(dst + (int64_t)c * out_channels + e) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

template <int TM, int TN, int WM, int WN, bool FOLDED>
int launch(const bf16* feats, const int32_t* idx, const bf16* dout,
           float* dst, int64_t batch, int64_t n_rows, int64_t m_rows,
           int64_t n_offsets, int64_t channels, int64_t out_channels,
           int64_t rows_per_slice, int64_t n_slices, cudaStream_t stream) {
  static int granted = 0;
  auto kernel = gather_dw_tc_kernel<TM, TN, WM, WN, FOLDED>;
  constexpr int smem = smem_bytes<TM, TN>();
  int err = tc::allow_smem(kernel, smem, granted);
  if (err != 0) return err;
  const dim3 grid(
      (unsigned)((out_channels + TN - 1) / TN),
      FOLDED ? 1u : (unsigned)((channels + TM - 1) / TM),
      (unsigned)(FOLDED ? n_slices : n_offsets * n_slices));
  kernel<<<grid, threads_of<TM, TN, WM, WN>(), smem, stream>>>(
      feats, idx, dout, dst, (int)n_rows, (int)m_rows, (int)n_offsets,
      (int)channels, (int)out_channels, batch * m_rows, rows_per_slice,
      (int)n_slices);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 feats [B, N, C] and dout [B, M, E]; idx [B, M, K] int32 in
// [0, N]; out [K, C, E] float32. variant 1 (generic: C % 8 == 0) with tile
// (TM, TN) = (128, 128) or (64, 64), or variant 2 (folded: K * C <= 128)
// with tile (128, 64). E % 8 == 0; feats (generic variant) and dout 16-byte
// aligned. The B * M rows are cut into n_slices slices of rows_per_slice
// rows; part is float32 scratch [n_slices, K, C, E] (unused, may be null,
// when n_slices is 1). Returns the first non-zero cudaError_t of the
// launches, or cudaErrorInvalidValue for a combination it does not take.
extern "C" int fcaf3d_gather_dw_tc(const void* feats, const int32_t* idx,
                                   const void* dout, float* part, float* out,
                                   int64_t batch, int64_t n_rows,
                                   int64_t m_rows, int64_t n_offsets,
                                   int64_t channels, int64_t out_channels,
                                   int64_t rows_per_slice, int64_t n_slices,
                                   int variant, int tile_m, int tile_n,
                                   void* stream) {
  const int64_t size = n_offsets * channels * out_channels;
  if (size == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (batch * m_rows == 0)
    return (int)cudaMemsetAsync(out, 0, size * sizeof(float), s);
  if (out_channels % 8 != 0 || batch * m_rows >= (int64_t)1 << 31 ||
      batch * n_rows >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  const bf16* f = (const bf16*)feats;
  const bf16* d = (const bf16*)dout;
  float* dst = n_slices == 1 ? out : part;
  int err = (int)cudaErrorInvalidValue;
  if (variant == 1 && channels % 8 == 0 && tile_m == 128 && tile_n == 128)
    err = launch<128, 128, 64, 32, false>(f, idx, d, dst, batch, n_rows,
                                          m_rows, n_offsets, channels,
                                          out_channels, rows_per_slice,
                                          n_slices, s);
  else if (variant == 1 && channels % 8 == 0 && tile_m == 64 && tile_n == 64)
    err = launch<64, 64, 32, 32, false>(f, idx, d, dst, batch, n_rows, m_rows,
                                        n_offsets, channels, out_channels,
                                        rows_per_slice, n_slices, s);
  else if (variant == 2 && n_offsets * channels <= kFoldRows &&
           tile_m == kFoldRows && tile_n == 64)
    err = launch<kFoldRows, 64, 32, 32, true>(f, idx, d, dst, batch, n_rows,
                                              m_rows, n_offsets, channels,
                                              out_channels, rows_per_slice,
                                              n_slices, s);
  if (err != 0 || n_slices == 1) return err;
  return sum_slices(part, out, size, (int)n_slices, s);
}
