// K6: ball query, the first `nsample` points within the radius in ascending
// index order.
//
// Replaces the TPU kernel fcaf3d_tpu/ops/pointnet/ballq_kernel.py::
// _scores_pallas (entry ball_query_grid). That kernel scores 128 candidates
// per (centre, neighbour-cell column) of a sorted cell grid, and a top-k
// picks the hits; the grid, its 128-candidate cap and the overflow counter
// exist so that the TPU avoids row gathers. The contract is its result
// whenever nothing overflows, which is the brute-force semantics:
//
//   centres [B, M, 3], points [B, N, 3] f32, optional valid [B, N] (bytes;
//   null = all valid) -> out [B, M, nsample] int32: the first nsample valid
//   points with (x-cx)^2 + (y-cy)^2 + (z-cz)^2 < r2, in ascending index,
//   the row padded with its first hit; a centre with no hit gives zeros.
//
// Rounding: the distance is ((dx*dx + dy*dy) + dz*dz) with every operation
// rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn), the TPU kernel's
// direct form, so that no fused multiply-add moves a point across r2.
//
// What bounds it on the H100: a centre scans points in index order until it
// has nsample hits. At VoteNet's SA1 (2048 centres in 20000 points, r 0.2,
// 64 samples) few points lie within 0.2 m, so nearly every centre scans the
// whole cloud: ~41 M distance tests of ~10 instructions a lane, some 15-20
// us of the 132 SMs' issue time. Read from L2 by every centre on its own,
// the 240 KB cloud moves ~490 MB, one dependent load a step: staging the
// cloud in shared memory removes that traffic and its latency. What is left
// is latency: SA1 puts ~16 centres on an SM, so few warps hide each other's
// stalls; hence one centre a warp (2 and 4 were slower at SA1: PERF.md),
// and straight-line tests with no state carried between steps.
//
// Design (`ball_query_tiled`): a CTA of kWarps warps owns kWarps centres,
// one a warp, its xyz and hit counter in registers (the CTAs are
// `ball_query_plan` in ops/pointnet/ball_query.py). The CTA stages the
// cloud in shared memory once for all of them, kTilePoints points a tile
// (xyz and the valid bytes), double-buffered so that the next tile's copy
// runs under the current tile's tests. One thread issues a tile's 16-byte
// lines as bulk copies (cp.async.bulk) that complete on the stage's
// mbarrier; the ragged head and tail (b N 12 bytes is not 16-byte aligned
// when N % 4 != 0), up to 3 floats and 15 valid bytes at each end, are
// loaded into registers by a few threads and stored before the tile is
// read. So the cloud crosses L2 once a CTA. In a tile each lane holds
// kUnroll points a step (neighbouring lanes, neighbouring points) and tests
// them against its warp's centre: one __ballot_sync per 32 points. The
// tests are straight-line code with no state carried from one step to the
// next: lane g keeps the ballot of group g of each window of 32 groups, and
// after the window the warp walks the groups with a hit in index order,
// giving each hit its slot after the centre's count by __popc of the lower
// lanes' bits. Warps split the centres, not the points, so every centre's
// hits land in index order with no sort and no prefix across warps. A
// centre's counter stops as soon as it is full (in mid-window), a warp
// whose centre is full skips the rest of the tile, and the CTA stops
// loading tiles when the vote at the tile boundary (__syncthreads_or, taken
// by every thread) finds no open centre. There is no candidate cap: nothing
// can overflow.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mbarrier.cuh"
#include "tensor_core.cuh"  // tc::smem_addr

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx,
                                         float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTilePoints = 2048;  // points a staged tile
constexpr int kWindow = 1024;      // points tested between two hit passes
constexpr int kUnroll = 8;         // groups of 32 points a lane loads at once
constexpr int kStep = 32 * kUnroll;
static_assert(kWindow == 32 * 32, "a window is one group of 32 a lane");
static_assert(kTilePoints % kWindow == 0 && kWindow % kStep == 0,
              "a warp's last step of a tile stays inside the stage");

// One stage of the double buffer: a tile's xyz, which starts at the float
// offset of its source within a 16-byte line (up to 3 floats), and its valid
// bytes, which start at their source's byte offset within a 16-byte line (up
// to 15 bytes), so that the bulk copies line up on both sides.
struct __align__(16) Stage {
  float xyz[3 * kTilePoints + 4];
  uint8_t valid[kTilePoints + 16];
};
constexpr int kSmemBytes = 2 * (int)sizeof(Stage) + 16;  // + two mbarriers

__device__ __forceinline__ int xyz_skew(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

__device__ __forceinline__ int valid_skew(const uint8_t* src) {
  return (int)(reinterpret_cast<uintptr_t>(src) & 15);
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory by the bulk-copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// *p = v where `pred` holds: a predicated store, with no divergent branch.
__device__ __forceinline__ void store_if(bool pred, int32_t* p, int32_t v) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q st.global.b32 [%0], "
      "%1;\n}\n" ::"l"(p),
      "r"(v), "r"((unsigned)pred)
      : "memory");
}

// A thread's share of a tile's ragged head and tail (the floats and valid
// bytes outside its 16-byte lines): loaded when the tile's copy starts,
// stored into the stage (at xpos / vpos; -1 none) before the tile is read.
struct Ragged {
  int xpos;
  float x;
  int vpos;
  uint8_t v;
};

// Starts the copy of one tile, `np` points from `src` (xyz) and `vsrc`
// (valid bytes, or null) into `s`: thread 0 issues the bulk copies of the
// 16-byte lines onto `bar` (the expected bytes first); threads 0-2 and 32-34
// load the ragged floats, threads 0-14 and 64-78 the ragged bytes.
__device__ __forceinline__ Ragged stage_tile(Stage& s, uint32_t bar,
                                             const float* src,
                                             const uint8_t* vsrc, int np,
                                             int tid) {
  Ragged r{-1, 0.f, -1, 0};
  const int nf = 3 * np;
  const int skew = xyz_skew(src);
  const int head = min(nf, (4 - skew) & 3);  // floats before the first line
  const int lines = (nf - head) >> 2;        // whole 16-byte lines
  const int tail0 = head + 4 * lines;        // up to 3 floats after them
  int at = tid < head ? tid : -1;
  if (tid >= 32 && tid - 32 < nf - tail0) at = tail0 + tid - 32;
  if (at >= 0) r = Ragged{skew + at, __ldg(src + at), -1, 0};
  int vskew = 0, vhead = 0, vlines = 0;
  if (vsrc != nullptr) {
    vskew = valid_skew(vsrc);
    vhead = min(np, (16 - vskew) & 15);
    vlines = (np - vhead) >> 4;
    const int vtail0 = vhead + 16 * vlines;
    at = tid < vhead ? tid : -1;
    if (tid >= 64 && tid - 64 < np - vtail0) at = vtail0 + tid - 64;
    if (at >= 0) {
      r.vpos = vskew + at;
      r.v = __ldg(vsrc + at);
    }
  }
  if (tid == 0) {
    // order this CTA's earlier accesses to the stage before the async writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(bar, 16u * (lines + vlines));
    if (lines > 0)
      bulk_copy(tc::smem_addr(s.xyz + skew + head), src + head, 16u * lines,
                bar);
    if (vlines > 0)
      bulk_copy(tc::smem_addr(s.valid + vskew + vhead), vsrc + vhead,
                16u * vlines, bar);
  }
  return r;
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    ball_query_tiled_kernel(const float* __restrict__ centers,
                            const float* __restrict__ points,
                            const uint8_t* __restrict__ valid,
                            int32_t* __restrict__ out, int m, int n,
                            int nsample, int ctas_per_cloud, float r2) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  const uint32_t bar0 = tc::smem_addr(smem + 2 * sizeof(Stage));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t b = blockIdx.x / ctas_per_cloud;
  // this warp's centre of cloud b
  const int mi = (int)(blockIdx.x % ctas_per_cloud) * kWarps + (tid >> 5);
  const float* p = points + b * n * 3;
  const uint8_t* v = kMasked ? valid + b * n : nullptr;
  const unsigned lower = (1u << lane) - 1u;

  // a centre past M reads the last one and starts full: it never tests
  const int64_t mc = b * m + min(mi, m - 1);
  int32_t* row = out + mc * nsample;
  const float cx = __ldg(centers + 3 * mc);
  const float cy = __ldg(centers + 3 * mc + 1);
  const float cz = __ldg(centers + 3 * mc + 2);
  int count = mi < m ? 0 : nsample;  // hits so far, the same in every lane
  int first = 0;                     // the first hit; 0 while there is none

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int tiles = (n + kTilePoints - 1) / kTilePoints;
  Ragged rag = stage_tile(stage[0], bar0, p, v, min(n, kTilePoints), tid);
  int t = 0;
  for (; t < tiles; ++t) {
    Stage& s = stage[t & 1];
    const int p0 = t * kTilePoints;
    const int np = min(n - p0, kTilePoints);
    float* xs = s.xyz + xyz_skew(p + 3 * p0);
    if (rag.xpos >= 0) s.xyz[rag.xpos] = rag.x;
    if (rag.vpos >= 0) s.valid[rag.vpos] = rag.v;
    // the short last tile: NaN past its points up to the warps' last step,
    // so that a read there is never a hit (no bound check in the loop)
    const int steps_end = 3 * ((np + kStep - 1) / kStep * kStep);
    for (int f = 3 * np + tid; f < steps_end; f += kThreads) xs[f] = NAN;
    if (t + 1 < tiles) {
      const int p1 = p0 + kTilePoints;
      rag = stage_tile(stage[(t + 1) & 1], bar0 + 8 * ((t + 1) & 1),
                       p + 3 * p1, kMasked ? v + p1 : nullptr,
                       min(n - p1, kTilePoints), tid);
    }
    mbar_wait(bar0 + 8 * (t & 1), (t >> 1) & 1);  // the lines of tile t
    __syncthreads();  // ... and every thread's ragged share and NaN
    const uint8_t* vs = kMasked ? s.valid + valid_skew(v + p0) : nullptr;
    // a full centre skips the rest of the tile
    for (int w0 = 0; w0 < np && count < nsample; w0 += kWindow) {
      // The tests: straight-line code with no state carried from one step
      // to the next, so that the steps overlap. Lane g keeps the centre's
      // ballot of the window's group g of 32 points.
      unsigned mine = 0u;
      const int w1 = min(np, w0 + kWindow);
      for (int g0 = w0; g0 < w1; g0 += kStep) {
        float px[kUnroll], py[kUnroll], pz[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = g0 + 32 * u + lane;
          px[u] = xs[3 * j];
          py[u] = xs[3 * j + 1];
          pz[u] = xs[3 * j + 2];
          ok[u] = !kMasked || vs[j] != 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float d2 = sq_dist(px[u], py[u], pz[u], cx, cy, cz);
          const unsigned h = __ballot_sync(kFull, ok[u] & (d2 < r2));
          mine = lane == ((g0 - w0) >> 5) + u ? h : mine;
        }
      }
      // The hits, group by group in index order: slots after the centre's
      // count, the first hit kept; the centre stops as soon as it is full.
      unsigned groups = __ballot_sync(kFull, mine != 0u);
      while (groups != 0u && count < nsample) {
        const int g = __ffs(groups) - 1;
        groups &= groups - 1u;
        const unsigned h = __shfl_sync(kFull, mine, g);
        const int base = p0 + w0 + 32 * g;
        first = count == 0 ? base + __ffs(h) - 1 : first;
        const int slot = count + __popc(h & lower);
        store_if(((h >> lane) & 1u) && slot < nsample, row + slot,
                 base + lane);
        count += __popc(h);
      }
    }
    // every thread votes; the stage of tile t is free again after it
    if (!__syncthreads_or(count < nsample)) break;
  }
  // a CTA that stopped early leaves no copy behind
  if (t + 1 < tiles) mbar_wait(bar0 + 8 * ((t + 1) & 1), ((t + 1) >> 1) & 1);

  if (mi >= m) return;
  for (int k = min(count, nsample) + lane; k < nsample; k += 32)
    row[k] = first;
}

// Grants the kernel its shared memory beyond the default 48 KB, once per
// instance and device (bit d of `granted` for device d < 64): the attribute
// call costs host time on every launch otherwise.
template <bool kMasked>
cudaError_t allow_tiled_smem() {
  static std::atomic<uint64_t> granted{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (granted.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ball_query_tiled_kernel<kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess) granted.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <bool kMasked>
int launch_tiled(const float* centers, const float* points,
                 const uint8_t* valid, int32_t* out, int m, int n,
                 int nsample, int per_cloud, float r2, unsigned blocks,
                 cudaStream_t stream) {
  const cudaError_t err = allow_tiled_smem<kMasked>();
  if (err != cudaSuccess) return (int)err;
  ball_query_tiled_kernel<kMasked><<<blocks, kThreads, kSmemBytes, stream>>>(
      centers, points, valid, out, m, n, nsample, per_cloud, r2);
  return (int)cudaGetLastError();
}

bool bad_shape(int64_t m, int64_t n, int64_t nsample) {
  return n <= 0 || n > INT32_MAX / 3 || m > INT32_MAX || nsample > INT32_MAX;
}

}  // namespace

// centers [B, M, 3], points [B, N, 3] f32 contiguous; valid [B, N] bytes or
// null; out [B, M, nsample] int32; r2 the squared radius in f32. One centre
// a warp, kWarps warps a CTA. Returns the cudaError_t of the launch.
extern "C" int fcaf3d_ball_query_tiled(const float* centers,
                                       const float* points,
                                       const uint8_t* valid, int32_t* out,
                                       int64_t batch, int64_t m, int64_t n,
                                       int64_t nsample, float r2,
                                       void* stream) {
  if (batch * m == 0 || nsample == 0) return 0;
  if (bad_shape(m, n, nsample)) return (int)cudaErrorInvalidValue;
  const int64_t per_cloud = (m + kWarps - 1) / kWarps;
  if (batch * per_cloud > INT32_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(batch * per_cloud);
  cudaStream_t s = (cudaStream_t)stream;
  return valid == nullptr
             ? launch_tiled<false>(centers, points, valid, out, (int)m,
                                   (int)n, (int)nsample, (int)per_cloud, r2,
                                   blocks, s)
             : launch_tiled<true>(centers, points, valid, out, (int)m, (int)n,
                                  (int)nsample, (int)per_cloud, r2, blocks, s);
}
