// K5: farthest-point sampling (D-FPS), first-occurrence ties.
//
// Replaces the TPU kernel fcaf3d_tpu/ops/pointnet/fps_kernel.py::_fps_pallas
// (entry fps_tpu), which runs the whole serial selection loop on one core
// with the cloud resident in VMEM as [R, 128] lane tiles.
//
// Contract (ops.furthest_point_sample): points [B, N, 3] f32, optional valid
// [B, N] (bytes 0/1; null = all valid) -> out [B, S] int32. out[0] is the
// first valid index (0 when none is). Each step measures
// d = (dx*dx + dy*dy) + dz*dz against the last chosen point, keeps
// dcur = min(dcur, d) (dcur starts at 1e10), masks invalid rows to -1 and
// takes the argmax, the lowest index among equal maxima.
//
// Rounding: every step of d is a separately rounded f32 operation
// (__fsub_rn, __fmul_rn, __fadd_rn), so nvcc cannot contract it into fused
// multiply-adds. One different rounding changes an argmax, and every later
// pick follows it, so the kernel must round exactly as the plain version.
//
// What bounds it on the H100: the S steps are serial, and each one is a pass
// over N points plus an argmax over the whole cloud. At N = 20000, S = 2048
// the work is ~40 M distance updates, tiny for the card; the time is
// S x (one step's latency): the pass over the points a thread holds, the
// argmax across threads and the barrier that publishes it.
//
// Two kernels, chosen by the wrapper's launch plan (ops/pointnet/fps.py,
// `fps_plan`) from the shape alone:
//
// "cluster" (fps_cluster_kernel): one thread-block cluster of `cs` CTAs per
// cloud (cs = 1 for the small clouds). CTA r owns a contiguous slice of the
// cloud and its thread t the P points (r * threads + t) * P + j, whose x, y,
// z and running minimum stay in registers for the whole run: after the
// first load no step touches L2. Thread, warp, CTA and candidate-slot orders
// are therefore index orders. The argmax compares a minimum's bits as a
// signed int (the float order for d >= +0); invalid points start at -1.0
// and padding at -0.5, which sort below every distance, invalid above
// padding, and min(code, d) keeps them, so no mask is read. One step:
//   1. each thread updates its P minima and takes its first best (a tree);
//   2. each warp takes `redux.sync` max of its lanes' bests and the lowest
//      lane at that max, which holds the lowest index there. The order
//      (larger value, then lower index) is total, so any partition and
//      reduction order gives the same winner: the partitioned argmax is
//      exact;
//   3. the warp's candidate (value bits, index, x, y, z) goes into slot
//      rank * warps + warp, of the step's parity k & 1, in every CTA of the
//      cluster: lane r stores into CTA r (mapa, the address that
//      cooperative groups' `cluster.map_shared_rank` gives, and st.async, a
//      store that completes its bytes on that CTA's mbarrier);
//   4. one synchronisation across the cluster (__syncthreads when cs = 1):
//      each CTA waits on its own mbarrier of that parity until the st.async
//      of all cs x warps candidates have completed their bytes there. No
//      CTA waits for another to reach a barrier, only for its candidates:
//      at SA1 on the H100 this took about half the time of a
//      barrier.cluster per step (PERF.md);
//   5. every warp of every CTA reduces all candidates from its own shared
//      memory to the same winner (a contiguous run of slots per lane, the
//      lowest lane at the max), which carries its coordinates: the next
//      step's centre needs no global load. Rank 0 writes out[b, k].
// The slots alternate by step parity: a CTA stores parity p of step k + 2
// only once it has all candidates of step k + 1, and each of those was sent
// after its warp had read parity p of step k. Step 0 is the same argmax over
// the initial minima (1e10 valid, -1 invalid): the first valid index, 0 when
// none is. A cluster barrier after the mbarriers' init, before any store
// into another CTA, and a last one, which keeps every CTA alive until no
// other can still store into its shared memory, are the only two.
//
// "single" (fps_kernel, the earlier kernel): one CTA of 1024 threads per
// cloud, the running minima in shared memory (a global scratch row beyond
// 48K points), the points re-read from global memory each step, two block
// barriers a step. The plan takes it only for clouds beyond the cluster
// kernel's register capacity; it stays reachable as the earlier kernel.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <array>
#include <mutex>
#include <vector>

#include "mbarrier.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (v, i) becomes (ov, oi) when that is a larger value, or an equal value
// at a lower index
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    take_better(v, i, ov, oi);
  }
}

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx,
                                         float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ points,
               const uint8_t* __restrict__ valid, int32_t* __restrict__ out,
               float* __restrict__ scratch, int n, int s) {
  extern __shared__ float smem_dcur[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int chosen;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = points + (int64_t)b * n * 3;
  const uint8_t* v = valid == nullptr ? nullptr : valid + (int64_t)b * n;
  int32_t* o = out + (int64_t)b * s;
  float* dcur = scratch == nullptr ? smem_dcur : scratch + (int64_t)b * n;

  // the start: the first valid index, 0 when none is valid
  int first = n;
  for (int i = tid; i < n; i += kThreads) {
    dcur[i] = 1e10f;
    if (first == n && (v == nullptr || v[i])) first = i;
  }
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(kFull, first, off));
  if (lane == 0) red_i[warp] = first;
  __syncthreads();
  if (warp == 0) {
    int f = red_i[lane];
    for (int off = 16; off > 0; off >>= 1)
      f = min(f, __shfl_xor_sync(kFull, f, off));
    if (lane == 0) {
      chosen = f < n ? f : 0;
      o[0] = chosen;
    }
  }
  __syncthreads();

  for (int k = 1; k < s; ++k) {
    const int last = chosen;
    const float lx = __ldg(p + 3 * last);
    const float ly = __ldg(p + 3 * last + 1);
    const float lz = __ldg(p + 3 * last + 2);
    float best_v = -INFINITY;
    int best_i = n;
    for (int i = tid; i < n; i += kThreads) {
      const float d = sq_dist(__ldg(p + 3 * i), __ldg(p + 3 * i + 1),
                              __ldg(p + 3 * i + 2), lx, ly, lz);
      const float dc = fminf(dcur[i], d);
      dcur[i] = dc;
      const float m = (v == nullptr || v[i]) ? dc : -1.0f;
      if (m > best_v) {  // ascending i: strict keeps the first occurrence
        best_v = m;
        best_i = i;
      }
    }
    warp_argmax(best_v, best_i);
    if (lane == 0) {
      red_v[warp] = best_v;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = red_v[lane];
      best_i = red_i[lane];
      warp_argmax(best_v, best_i);
      if (lane == 0) {
        chosen = best_i;
        o[k] = best_i;
      }
    }
    __syncthreads();
  }
}

// ---- "cluster" ----

constexpr int kMaxCluster = 16;
constexpr int kMaxCands = kMaxCluster * kWarps;
// a candidate's bytes, as stored into each CTA: its key (4) and its point
// with the index in w (16)
constexpr int kCandBytes = 20;
// the argmax compares a minimum's bits as a signed int: for d >= +0 that is
// the float order, and the two negative codes sort below every distance in
// this order (invalid above padding), while min(code, d) keeps each code
constexpr float kInvalid = -1.0f;  // int -1082130432
constexpr float kPadding = -0.5f;  // int -1090519040
constexpr int kNoCandidate = INT_MIN;

// points a thread holds -> the most threads a CTA may have (the registers
// of P = 20 points, 80 floats, fit the 128 a thread gets at 512 threads)
template <int P>
struct MaxThreads {
  static constexpr int value = P <= 4 ? 1024 : 512;
};

// distributed shared memory, in PTX (the mbarriers: mbarrier.cuh)
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

// the address of local shared address `local` in the shared memory of CTA
// `rank` (what cooperative groups' `cluster.map_shared_rank` compiles to)
__device__ __forceinline__ unsigned cluster_addr(unsigned local,
                                                 unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// st.async: a store into CTA `rank`'s shared memory that completes its
// bytes on that CTA's mbarrier `bar` (both cluster addresses)
__device__ __forceinline__ void async_store(unsigned addr, int v,
                                            unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.s32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void async_store(unsigned addr, float4 v,
                                            unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// barrier.cluster: every thread of every CTA arrives (release: its stores
// into the cluster's shared memory become visible) and waits (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int P>
__global__ void __launch_bounds__(MaxThreads<P>::value)
    fps_cluster_kernel(const float* __restrict__ points,
                       const uint8_t* __restrict__ valid,
                       int32_t* __restrict__ out, int n, int s, int cs) {
  extern __shared__ float4 own_xyz[];  // [threads * P]: this CTA's slice
  __shared__ int cand_key[2][kMaxCands];  // by step parity, in index order
  __shared__ float4 cand_pt[2][kMaxCands];  // x, y, z, index bits
  __shared__ uint64_t bar[2];  // cs > 1: one per step parity

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int ncand = cs * warps;
  const int per_lane = (ncand + 31) >> 5;  // candidates a lane reduces
  const int rank = (int)cluster_rank();
  const int b = blockIdx.x / cs;
  // thread tid holds points base + tid * P + j, j ascending: thread, warp,
  // CTA and candidate slot (rank * warps + warp) orders are index orders
  const int base = (rank * threads + tid) * P;
  const float* p = points + (int64_t)b * n * 3;
  const uint8_t* v = valid == nullptr ? nullptr : valid + (int64_t)b * n;
  int32_t* o = out + (int64_t)b * s;

  float x[P], y[P], z[P], dcur[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = base + j;
    if (i < n) {
      x[j] = p[3 * i];
      y[j] = p[3 * i + 1];
      z[j] = p[3 * i + 2];
      dcur[j] = (v == nullptr || v[i]) ? 1e10f : kInvalid;
    } else {
      x[j] = y[j] = z[j] = 0.0f;
      dcur[j] = kPadding;
    }
    // read back only by this thread, for its best point
    own_xyz[tid * P + j] = make_float4(x[j], y[j], z[j], __int_as_float(i));
  }
  const unsigned bytes = (unsigned)(ncand * kCandBytes);
  if (cs > 1) {
    if (tid == 0) {
      mbar_init(smem_addr(&bar[0]), 1);
      mbar_init(smem_addr(&bar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect(smem_addr(&bar[0]), bytes);
      mbar_expect(smem_addr(&bar[1]), bytes);
    }
    // every CTA of the cluster has started and its mbarriers exist before
    // the first store into its shared memory
    cluster_sync();
  }
  // lane r < cs stores the warp's candidate into CTA r: its addresses there
  unsigned r_key[2] = {0u, 0u}, r_pt[2] = {0u, 0u}, r_bar[2] = {0u, 0u};
  if (cs > 1 && lane < cs) {
    const int slot = rank * warps + warp;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      r_key[q] = cluster_addr(smem_addr(&cand_key[q][slot]), lane);
      r_pt[q] = cluster_addr(smem_addr(&cand_pt[q][slot]), lane);
      r_bar[q] = cluster_addr(smem_addr(&bar[q]), lane);
    }
  }

  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  for (int k = 0; k < s; ++k) {
    if (k > 0) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        dcur[j] = fminf(dcur[j], sq_dist(x[j], y[j], z[j], cx, cy, cz));
    }
    // this thread's first best (a pairwise tree: the left, lower-index
    // side wins ties), then the warp's: the lowest lane at the warp's
    // maximum holds the lowest index there
    int tv[P], tj[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      tv[j] = __float_as_int(dcur[j]);
      tj[j] = j;
    }
#pragma unroll
    for (int w = 1; w < P; w *= 2) {
#pragma unroll
      for (int j = 0; j + w < P; j += 2 * w) {
        if (tv[j + w] > tv[j]) {
          tv[j] = tv[j + w];
          tj[j] = tj[j + w];
        }
      }
    }
    const int best = tv[0];
    const float4 mine = own_xyz[tid * P + tj[0]];
    const int wbest = __reduce_max_sync(kFull, best);
    const int wl = __ffs(__ballot_sync(kFull, best == wbest)) - 1;

    const int par = k & 1;
    if (cs == 1) {
      if (lane == wl) {
        cand_key[par][warp] = wbest;
        cand_pt[par][warp] = mine;
      }
      __syncthreads();
    } else {
      float4 w;
      w.x = __shfl_sync(kFull, mine.x, wl);
      w.y = __shfl_sync(kFull, mine.y, wl);
      w.z = __shfl_sync(kFull, mine.z, wl);
      w.w = __shfl_sync(kFull, mine.w, wl);
      // selects, not r_key[par]: a dynamic index would put them on the stack
      const unsigned a_key = par ? r_key[1] : r_key[0];
      const unsigned a_pt = par ? r_pt[1] : r_pt[0];
      if (lane < cs) {
        const unsigned a_bar = par ? r_bar[1] : r_bar[0];
        async_store(a_key, wbest, a_bar);
        async_store(a_pt, w, a_bar);
      }
      mbar_wait(smem_addr(&bar[par]), (k >> 1) & 1);
      // re-arm this parity for step k + 2: its stores can land earlier
      // (the count then runs below zero) but cannot complete it before the
      // arm
      if (tid == 0 && k + 2 < s) mbar_expect(smem_addr(&bar[par]), bytes);
    }

    // every warp: all candidates, a contiguous run per lane, so that the
    // lowest lane at the maximum again holds the lowest index
    int bk = kNoCandidate;
    float4 cand;
    if (per_lane == 1) {  // both loads at once
      if (lane < ncand) bk = cand_key[par][lane];
      cand = cand_pt[par][lane < ncand ? lane : 0];
    } else {
      int bs = 0;
      for (int c = lane * per_lane, e = min(c + per_lane, ncand); c < e;
           ++c) {
        const int key = cand_key[par][c];
        if (key > bk) {
          bk = key;
          bs = c;
        }
      }
      cand = cand_pt[par][bs];
    }
    const int mk = __reduce_max_sync(kFull, bk);
    const int ml = __ffs(__ballot_sync(kFull, bk == mk)) - 1;
    cx = __shfl_sync(kFull, cand.x, ml);
    cy = __shfl_sync(kFull, cand.y, ml);
    cz = __shfl_sync(kFull, cand.z, ml);
    const float mi = __shfl_sync(kFull, cand.w, ml);
    if (rank == 0 && tid == 0) o[k] = __float_as_int(mi);
  }
  // no CTA leaves while another may still store into its shared memory
  if (cs > 1) cluster_sync();
}

// The kernel's attributes (the most dynamic shared memory any launch of
// this instance asks for; clusters above 8) and the check that the card can
// place one cluster of this launch shape, once per (device, cs, threads):
// the occupancy query alone costs more host time than the launch.
template <int P>
cudaError_t prepare(const cudaLaunchConfig_t& config, int cs, int threads) {
  static std::mutex mu;
  static std::vector<std::array<int, 3>> placed;  // (device, cs, threads)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::array<int, 3> key = {device, cs, threads};
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& k : placed)
    if (k == key) return cudaSuccess;
  auto kernel = fps_cluster_kernel<P>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(P * MaxThreads<P>::value * sizeof(float4)));
  if (err != cudaSuccess) return err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  // a cluster the card cannot place would never run: refuse it here
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters == 0) return cudaErrorLaunchOutOfResources;
  placed.push_back(key);
  return cudaSuccess;
}

// one launch of the cluster kernel: the tensors, shape and plan; with
// `clusters` set, no launch: the clusters of this shape the card can hold
// at once go there
struct Launch {
  const float* points;
  const uint8_t* valid;
  int32_t* out;
  int batch, n, s, cs, threads;
  cudaStream_t stream;
  int* clusters;
};

template <int P>
int launch_cluster(const Launch& a) {
  if (a.threads > MaxThreads<P>::value) return (int)cudaErrorInvalidValue;
  auto kernel = fps_cluster_kernel<P>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(a.batch * a.cs));
  config.blockDim = dim3((unsigned)a.threads);
  config.dynamicSmemBytes = (size_t)P * a.threads * sizeof(float4);
  config.stream = a.stream;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = prepare<P>(config, a.cs, a.threads);
  if (err != cudaSuccess) return (int)err;
  if (a.clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(a.clusters, kernel, &config);
  err = cudaLaunchKernelEx(&config, kernel, a.points, a.valid, a.out, a.n,
                           a.s, a.cs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the instances: ops/pointnet/fps.py's POINTS_PER_THREAD (a CPU test reads
// these cases and MaxThreads back from this file)
int launch_cluster_p(const Launch& a, int ppt) {
  switch (ppt) {
    case 1: return launch_cluster<1>(a);
    case 2: return launch_cluster<2>(a);
    case 4: return launch_cluster<4>(a);
    case 8: return launch_cluster<8>(a);
    case 12: return launch_cluster<12>(a);
    case 16: return launch_cluster<16>(a);
    case 20: return launch_cluster<20>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// points [B, N, 3] f32 contiguous; valid [B, N] bytes or null (all valid);
// out [B, S] int32; scratch [B, N] f32 or null: null keeps the running
// minima in dynamic shared memory (N * 4 bytes, which the caller keeps
// within the card's per-block limit). Returns the cudaError_t of the launch.
extern "C" int fcaf3d_fps(const float* points, const uint8_t* valid,
                          int32_t* out, float* scratch, int64_t batch,
                          int64_t n, int64_t s, void* stream) {
  if (batch == 0 || s == 0) return 0;
  if (n <= 0 || n > INT32_MAX / 3 || s > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = scratch == nullptr ? (size_t)n * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fps_kernel<<<(unsigned)batch, kThreads, smem, (cudaStream_t)stream>>>(
      points, valid, out, scratch, (int)n, (int)s);
  return (int)cudaGetLastError();
}

// The cluster kernel with the plan: cs CTAs a cloud, `threads` a CTA,
// `ppt` points a thread (cs * threads * ppt >= N). Same tensors as
// fcaf3d_fps, no scratch. Returns the cudaError_t of the launch, and
// cudaErrorLaunchOutOfResources when the card cannot place one cluster.
extern "C" int fcaf3d_fps_cluster(const float* points, const uint8_t* valid,
                                  int32_t* out, int64_t batch, int64_t n,
                                  int64_t s, int cs, int threads, int ppt,
                                  void* stream) {
  if (batch == 0 || s == 0) return 0;
  if (n <= 0 || n > INT32_MAX / 3 || s > INT32_MAX || cs < 1 ||
      cs > kMaxCluster || batch * cs > INT32_MAX || threads < 32 ||
      threads > kThreads || threads % 32 != 0 ||
      (int64_t)cs * threads * ppt < n)
    return (int)cudaErrorInvalidValue;
  const Launch a = {points, valid, out, (int)batch, (int)n, (int)s, cs,
                    threads, (cudaStream_t)stream, nullptr};
  return launch_cluster_p(a, ppt);
}

// The clusters of the cluster kernel's plan (cs CTAs of `threads`, `ppt`
// points a thread) that the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *clusters; nothing is launched.
// Returns the cudaError_t of the query.
extern "C" int fcaf3d_fps_cluster_occupancy(int cs, int threads, int ppt,
                                            int* clusters) {
  if (cs < 1 || cs > kMaxCluster || threads < 32 || threads > kThreads ||
      threads % 32 != 0 || clusters == nullptr)
    return (int)cudaErrorInvalidValue;
  const Launch a = {nullptr, nullptr, nullptr, 1, 1, 1, cs, threads, nullptr,
                    clusters};
  return launch_cluster_p(a, ppt);
}
