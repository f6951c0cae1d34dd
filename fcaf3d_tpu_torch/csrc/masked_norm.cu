// K7: the masked norm of the sparse FCAF3D path with the residual add and
// the activation that follow it, forward and backward.
//
// Replaces no TPU kernel: the JAX package computes its masked BatchNorm and
// InstanceNorm (fcaf3d_tpu/models/blocks.py::SparseBatchNorm,
// SparseInstanceNorm) and the ReLU / ELU / residual add after them as jnp
// ops, which XLA fuses on the TPU. Eager PyTorch runs the same chain as ~30
// ops a norm, each a full pass over the [B, budget, C] rows, and autograd
// keeps f32 copies of them for the backward.
//
// What bounds it on the H100: memory traffic. A norm reads its rows a few
// times and does a handful of flops a byte. Most rows of a training
// budget are padding (keys == SENTINEL): the backbone's levels are 7-19%
// full at batch 16. So the design reads only the valid rows' features:
//
// - Every kernel runs the same grid, (CTAs a group, groups): a group is the
//   whole batch (BatchNorm) or one sample (InstanceNorm); a CTA owns a
//   fixed block of a group's rows (`norm_plan` in ops/sparse/masked_norm.py,
//   a function of the shapes alone) and reads the keys of its rows. A row
//   whose key is SENTINEL costs its 8-byte key; no feature of it is read.
//   Valid rows need not be a prefix (the reference neck's child maps are
//   parent-major).
// - A thread owns `V` channels of one row at a time (16 bytes where C
//   fills them), `rp` rows of the block in parallel, and issues the loads
//   of 4 rows (2 in the backward, which reads three inputs) before it uses
//   any.
// - The statistics are two passes, as the plain path takes them: the sums
//   (`norm_stats`), then the squared deviations about the final mean
//   (`norm_dev`). Each CTA writes its f32 partial to scratch; the last CTA
//   to finish (an integer ticket) adds the partials in CTA order, by
//   16-byte loads, so every result repeats bitwise. The only other atomic
//   adds the CTAs' integer counts of valid rows. `norm_plan` bounds the
//   partials a launch writes so that this last step stays short. The
//   caller may all-reduce the sums over data-parallel ranks between the
//   kernels.
// - `norm_apply` normalises, rounds to the activations' dtype, adds the
//   residual (rounding once), applies ReLU or ELU (expm1), writes zeros on
//   invalid rows without reading them, and moves the running statistics.
// - Backward: `norm_bwd_reduce` recomputes the activation's input from the
//   saved input and the per-channel statistics, takes g = dy through the
//   activation's derivative (ReLU's is 1/2 at exactly 0, as the plain
//   path's `torch.maximum` gives it) and sums g and g * (x - mean) per
//   channel (the scale's and bias's gradients come from these); then
//   `norm_bwd_apply` writes dx = inv * (g - sum g / n - (x - mean) * sum
//   g (x - mean) / (n (var + eps))) and the residual's gradient g.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>
#include <type_traits>

#include "elementwise.cuh"

namespace {

constexpr int64_t kSentinel = 0xFFFFFFFFll;  // keys: int64 holding uint32
// threads a CTA at most: 128 registers a thread for the loads in flight
constexpr int kMaxThreads = 512;
// rows a thread loads before it uses any: forward, backward (three inputs)
constexpr int kUnroll = 4, kUnrollBwd = 2;
// the statistics: running (eval BN), batch (train BN), per sample (IN)
constexpr int kRunning = 0, kBatch = 1, kInstance = 2;

// v rounded to T: the plain path's cast to the activations' dtype
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    T h[V];
    memcpy(h, &u, 16);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_float(h[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_float(__ldg(p + e));
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  T h[V];
#pragma unroll
  for (int e = 0; e < V; ++e) h[e] = from_float<T>(v[e]);
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    memcpy(&u, h, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = h[e];
  }
}

// The launch's geometry: group g = blockIdx.y holds `ng` rows of `c`
// channels; CTA blockIdx.x owns rows [r0, r1) of it; a thread owns the `V`
// channels from `lane * V` of rows r0 + rl, r0 + rl + rp, ...
struct Geo {
  int64_t r0, r1, base;  // base: the group's first row in the tensor
  int c, lane, rl, rp;
};

template <int V>
__device__ __forceinline__ Geo geometry(int64_t ng, int c, int64_t rows) {
  Geo q;
  const int tpr = c / V;
  q.c = c;
  q.lane = threadIdx.x % tpr;
  q.rl = threadIdx.x / tpr;
  q.rp = blockDim.x / tpr;
  q.r0 = blockIdx.x * rows;
  q.r1 = min(q.r0 + rows, ng);
  q.base = (int64_t)blockIdx.y * ng;
  return q;
}

// Per-channel statistics of group g: from the sums (`a` = [G, 1 + C] count
// and sums, `b` = [G, C] squared deviations) or, in mode kRunning, `a` /
// `b` the running mean / variance [C].
__device__ __forceinline__ void channel_stats(const float* a, const float* b,
                                              int mode, int g, int c, int ch,
                                              float& mean, float& var) {
  if (mode != kRunning) {
    const float n = fmaxf(a[(int64_t)g * (1 + c)], 1.f);
    mean = __fdiv_rn(a[(int64_t)g * (1 + c) + 1 + ch], n);
    var = __fdiv_rn(b[(int64_t)g * c + ch], n);
  } else {
    mean = a[ch];
    var = b[ch];
  }
}

// A channel's factors of the norm, in the plain path's order of
// operations: BatchNorm (x - mean) * a with a = scale / sqrt(var + eps);
// InstanceNorm (x - mean) / a * b with a = sqrt(var + eps), b = scale.
template <bool INST>
__device__ __forceinline__ void channel_affine(float var, float eps,
                                               float scale, float& a,
                                               float& b) {
  const float sd = __fsqrt_rn(__fadd_rn(var, eps));
  a = INST ? sd : __fdiv_rn(scale, sd);
  b = scale;
}

// The activation's input: the norm plus the shift, rounded to T, plus the
// residual, rounded once more.
template <typename T, bool INST>
__device__ __forceinline__ float pre_act(float x, float mean, float a,
                                         float b, float shift, bool has_res,
                                         float res) {
  const float d = __fsub_rn(x, mean);
  const float n = INST ? __fmul_rn(__fdiv_rn(d, a), b) : __fmul_rn(d, a);
  float y = round_to<T>(__fadd_rn(n, shift));
  if (has_res) y = round_to<T>(__fadd_rn(y, res));
  return y;
}

template <typename T>
__device__ __forceinline__ float activate(float r, int act) {
  if (act == kRelu) return r > 0.f || isnan(r) ? r : 0.f;
  if (act == kElu) return r > 0.f ? r : round_to<T>(expm1f(r));
  return r;
}

// dy through the activation at r, in T as autograd computes it: ReLU
// (`torch.maximum(r, 0)`) passes dy / 2 at r == 0; ELU's negative side
// passes dy * (expm1(r) + 1), each step rounded to T.
template <typename T>
__device__ __forceinline__ float act_grad(float r, float dy, int act) {
  if (act == kRelu)
    return r > 0.f ? dy : (r == 0.f ? round_to<T>(dy * 0.5f) : 0.f);
  if (act == kElu)
    return r > 0.f ? dy
                   : round_to<T>(dy * round_to<T>(
                                          round_to<T>(expm1f(r)) + 1.f));
  return dy;
}

// The thread's NA accumulators of V channels -> the CTA's partial
// part[blk][a * c + ch] (row lanes added in order); returns, in thread 0,
// the CTA's count of valid rows (`n` a row lane). smem holds NA * V *
// blockDim.x floats; scnt one int a row lane.
template <int NA, int V>
__device__ int cta_partial(const Geo& q, const float (&acc)[NA][V], int n,
                           float* smem, int* scnt, float* part, int64_t blk) {
  const int w = NA * q.c;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int e = 0; e < V; ++e)
      smem[q.rl * w + a * q.c + q.lane * V + e] = acc[a][e];
  if (q.lane == 0) scnt[q.rl] = n;
  __syncthreads();
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    float s = smem[i];
    for (int r = 1; r < q.rp; ++r) s += smem[r * w + i];
    part[blk * w + i] = s;
  }
  int total = 0;
  if (threadIdx.x == 0)
    for (int r = 0; r < q.rp; ++r) total += scnt[r];
  return total;
}

// True in the last CTA of the grid to get here, after every CTA's partial
// (and count) is visible to it.
__device__ bool last_cta(int* ticket) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int total = (int)(gridDim.x * gridDim.y);
    is_last = atomicAdd(ticket, 1) == total - 1;
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// In the last CTA: out[g * stride + off + i] = the sum over the group's
// `blocks` CTAs p, in order, of part[g * blocks + p][i] (i < w), F floats
// a load. When the columns are fewer than the threads, S threads split a
// column's CTAs into S ranges, added in order after. Resets the ticket.
template <int F>
__device__ void final_sums(const float* part, float* smem, int groups,
                           int64_t blocks, int w, float* out, int stride,
                           int off, int* ticket) {
  using L = typename std::conditional<F == 4, float4, float>::type;
  const int wf = w / F, cols = groups * wf, nt = blockDim.x;
  const int S = cols >= nt ? 1 : nt / cols;
  for (int t = threadIdx.x; t < S * cols; t += nt) {
    const int col = t % cols, s = t / cols;
    const int g = col / wf, i = col % wf;
    const int64_t p0 = blocks * s / S, p1 = blocks * (s + 1) / S;
    float acc[F] = {};
    const L* src = reinterpret_cast<const L*>(part) + g * blocks * wf + i;
#pragma unroll 8
    for (int64_t p = p0; p < p1; ++p) {
      const L v = __ldcg(src + p * wf);
      const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
      for (int e = 0; e < F; ++e) acc[e] += f[e];
    }
    if (S == 1) {
#pragma unroll
      for (int e = 0; e < F; ++e)
        out[(int64_t)g * stride + off + i * F + e] = acc[e];
    } else {
#pragma unroll
      for (int e = 0; e < F; ++e) smem[(s * cols + col) * F + e] = acc[e];
    }
  }
  if (S > 1) {
    __syncthreads();
    for (int t = threadIdx.x; t < cols * F; t += nt) {
      float acc = smem[t];
      for (int s = 1; s < S; ++s) acc += smem[s * cols * F + t];
      const int col = t / F;
      out[(int64_t)(col / wf) * stride + off + (col % wf) * F + t % F] = acc;
    }
  }
  if (threadIdx.x == 0) *ticket = 0;
}

__device__ void final_sums_any(const float* part, float* smem, int groups,
                               int64_t blocks, int w, float* out, int stride,
                               int off, int* ticket) {
  if (w % 4 == 0)
    final_sums<4>(part, smem, groups, blocks, w, out, stride, off, ticket);
  else
    final_sums<1>(part, smem, groups, blocks, w, out, stride, off, ticket);
}

// ---- forward ---------------------------------------------------------------

// sums[g] = [count of valid rows, sum of their rows] of each group.
// tickets[0] is the ticket, tickets[1 + g] group g's count while it runs.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    norm_stats_kernel(const T* __restrict__ x,
                      const int64_t* __restrict__ keys, float* part,
                      float* sums, int* tickets, int64_t ng, int c,
                      int64_t rows) {
  extern __shared__ float smem[];
  __shared__ int scnt[kMaxThreads];
  const Geo q = geometry<V>(ng, c, rows);
  float acc[1][V] = {};
  int n = 0;
  for (int64_t r = q.r0 + q.rl; r < q.r1; r += kUnroll * (int64_t)q.rp) {
    float v[kUnroll][V];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = q.base + r + u * (int64_t)q.rp;
      ok[u] = r + u * (int64_t)q.rp < q.r1 && __ldg(keys + row) != kSentinel;
      if (ok[u]) load_vec<T, V>(x + row * c + q.lane * V, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[0][e] += v[u][e];
      ++n;
    }
  }
  const int64_t blk = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int count = cta_partial<1, V>(q, acc, n, smem, scnt, part, blk);
  if (threadIdx.x == 0 && count > 0) atomicAdd(tickets + 1 + blockIdx.y, count);
  if (!last_cta(tickets)) return;
  for (int g = threadIdx.x; g < (int)gridDim.y; g += blockDim.x) {
    sums[(int64_t)g * (1 + c)] = (float)atomicExch(tickets + 1 + g, 0);
  }
  final_sums_any(part, smem, gridDim.y, gridDim.x, c, sums, 1 + c, 1,
                 tickets);
}

// sq[g] = the sum of (x - mean)^2 over each group's valid rows, the mean
// from `sums` (after any all-reduce of it).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    norm_dev_kernel(const T* __restrict__ x, const int64_t* __restrict__ keys,
                    const float* __restrict__ sums, float* part, float* sq,
                    int* tickets, int64_t ng, int c, int64_t rows) {
  extern __shared__ float smem[];
  __shared__ int scnt[kMaxThreads];
  const Geo q = geometry<V>(ng, c, rows);
  const float* gs = sums + (int64_t)blockIdx.y * (1 + c);
  const float cnt = fmaxf(gs[0], 1.f);
  float mean[V];
#pragma unroll
  for (int e = 0; e < V; ++e) mean[e] = __fdiv_rn(gs[1 + q.lane * V + e], cnt);
  float acc[1][V] = {};
  for (int64_t r = q.r0 + q.rl; r < q.r1; r += kUnroll * (int64_t)q.rp) {
    float v[kUnroll][V];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = q.base + r + u * (int64_t)q.rp;
      ok[u] = r + u * (int64_t)q.rp < q.r1 && __ldg(keys + row) != kSentinel;
      if (ok[u]) load_vec<T, V>(x + row * c + q.lane * V, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = __fsub_rn(v[u][e], mean[e]);
        acc[0][e] += d * d;
      }
    }
  }
  const int64_t blk = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  cta_partial<1, V>(q, acc, 0, smem, scnt, part, blk);
  if (!last_cta(tickets)) return;
  final_sums_any(part, smem, gridDim.y, gridDim.x, c, sq, c, 0, tickets);
}

// out = act(round(round(norm(x) + shift) + res)) on valid rows, 0 on the
// others (`pre_act`). With `run_mean`, CTA (0, 0) moves the running
// statistics by keep * running + m * batch.
template <typename T, int V, bool INST>
__global__ void __launch_bounds__(kMaxThreads)
    norm_apply_kernel(const T* __restrict__ x,
                      const int64_t* __restrict__ keys,
                      const T* __restrict__ res, const float* stat_a,
                      const float* stat_b, int mode,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, float* run_mean,
                      float* run_var, float keep, float m, T* out,
                      int64_t ng, int c, int64_t rows, int act, float eps) {
  const Geo q = geometry<V>(ng, c, rows);
  float mean[V], a[V], b[V], sh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int ch = q.lane * V + e;
    float var;
    channel_stats(stat_a, stat_b, mode, blockIdx.y, c, ch, mean[e], var);
    channel_affine<INST>(var, eps, scale[ch], a[e], b[e]);
    sh[e] = shift[ch];
    if (run_mean != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
        q.rl == 0) {
      run_mean[ch] = __fadd_rn(__fmul_rn(keep, run_mean[ch]),
                               __fmul_rn(m, mean[e]));
      run_var[ch] = __fadd_rn(__fmul_rn(keep, run_var[ch]), __fmul_rn(m, var));
    }
  }
  const bool has_res = res != nullptr;
  for (int64_t r = q.r0 + q.rl; r < q.r1; r += kUnroll * (int64_t)q.rp) {
    float v[kUnroll][V], w[kUnroll][V] = {};
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = q.base + r + u * (int64_t)q.rp;
      ok[u] = r + u * (int64_t)q.rp < q.r1 && __ldg(keys + row) != kSentinel;
      if (ok[u]) {
        load_vec<T, V>(x + row * c + q.lane * V, v[u]);
        if (has_res) load_vec<T, V>(res + row * c + q.lane * V, w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * (int64_t)q.rp >= q.r1) continue;
      const int64_t row = q.base + r + u * (int64_t)q.rp;
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = ok[u] ? activate<T>(pre_act<T, INST>(v[u][e], mean[e], a[e],
                                                    b[e], sh[e], has_res,
                                                    w[u][e]),
                                   act)
                     : 0.f;
      store_vec<T, V>(out + row * c + q.lane * V, o);
    }
  }
}

// ---- backward --------------------------------------------------------------

// gsum[g] = [sum g, sum g * (x - mean)] over each group's valid rows, g = dy
// through the activation; dshift = the sum over groups of sum g, dscale
// = the sum over groups of sum g * (x - mean) / sqrt(var + eps).
template <typename T, int V, bool INST>
__global__ void __launch_bounds__(kMaxThreads)
    norm_bwd_reduce_kernel(const T* __restrict__ x,
                           const int64_t* __restrict__ keys,
                           const T* __restrict__ res,
                           const T* __restrict__ dy, const float* stat_a,
                           const float* stat_b, int mode,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift, float* part,
                           float* gsum, float* dscale, float* dshift,
                           int* tickets, int64_t ng, int c, int64_t rows,
                           int act, float eps) {
  extern __shared__ float smem[];
  __shared__ int scnt[kMaxThreads];
  const Geo q = geometry<V>(ng, c, rows);
  float mean[V], a[V], b[V], sh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int ch = q.lane * V + e;
    float var;
    channel_stats(stat_a, stat_b, mode, blockIdx.y, c, ch, mean[e], var);
    channel_affine<INST>(var, eps, scale[ch], a[e], b[e]);
    sh[e] = shift[ch];
  }
  const bool has_res = res != nullptr;
  float acc[2][V] = {};
  for (int64_t r = q.r0 + q.rl; r < q.r1; r += kUnrollBwd * (int64_t)q.rp) {
    float v[kUnrollBwd][V], w[kUnrollBwd][V] = {}, d[kUnrollBwd][V];
    bool ok[kUnrollBwd];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int64_t row = q.base + r + u * (int64_t)q.rp;
      ok[u] = r + u * (int64_t)q.rp < q.r1 && __ldg(keys + row) != kSentinel;
      if (ok[u]) {
        load_vec<T, V>(x + row * c + q.lane * V, v[u]);
        load_vec<T, V>(dy + row * c + q.lane * V, d[u]);
        if (has_res) load_vec<T, V>(res + row * c + q.lane * V, w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float g = act_grad<T>(
            pre_act<T, INST>(v[u][e], mean[e], a[e], b[e], sh[e], has_res,
                             w[u][e]),
            d[u][e], act);
        acc[0][e] += g;
        acc[1][e] += g * __fsub_rn(v[u][e], mean[e]);
      }
    }
  }
  const int64_t blk = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  cta_partial<2, V>(q, acc, 0, smem, scnt, part, blk);
  if (!last_cta(tickets)) return;
  const int groups = gridDim.y;
  final_sums_any(part, smem, groups, gridDim.x, 2 * c, gsum, 2 * c, 0,
                 tickets);
  __syncthreads();  // gsum, written by this CTA, is read below
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float db = 0.f, ds = 0.f;
    for (int g = 0; g < groups; ++g) {
      float mu, var;
      channel_stats(stat_a, stat_b, mode, g, c, ch, mu, var);
      db += gsum[(int64_t)g * 2 * c + ch];
      ds += __fdiv_rn(gsum[(int64_t)g * 2 * c + c + ch],
                      __fsqrt_rn(__fadd_rn(var, eps)));
    }
    dshift[ch] = db;
    dscale[ch] = ds;
  }
}

// dx = inv * (g - sum g / n - (x - mean) * sum g (x - mean) / (n (var +
// eps))), inv = scale / sqrt(var + eps), with batch or per-sample
// statistics (the sums after any all-reduce), inv * g with running ones;
// dres = g; both 0 on invalid rows.
template <typename T, int V, bool INST>
__global__ void __launch_bounds__(kMaxThreads)
    norm_bwd_apply_kernel(const T* __restrict__ x,
                          const int64_t* __restrict__ keys,
                          const T* __restrict__ res, const T* __restrict__ dy,
                          const float* stat_a, const float* stat_b,
                          int mode, const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          const float* __restrict__ gsum, T* dx, T* dres,
                          int64_t ng, int c, int64_t rows, int act,
                          float eps) {
  const Geo q = geometry<V>(ng, c, rows);
  const int g0 = blockIdx.y;
  float mean[V], a[V], b[V], sh[V], s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int ch = q.lane * V + e;
    float var;
    channel_stats(stat_a, stat_b, mode, g0, c, ch, mean[e], var);
    channel_affine<INST>(var, eps, scale[ch], a[e], b[e]);
    sh[e] = shift[ch];
    s1[e] = s2[e] = 0.f;
    if (mode != kRunning) {
      const float n = fmaxf(stat_a[(int64_t)g0 * (1 + c)], 1.f);
      s1[e] = __fdiv_rn(gsum[(int64_t)g0 * 2 * c + ch], n);
      s2[e] = __fdiv_rn(gsum[(int64_t)g0 * 2 * c + c + ch],
                        n * __fadd_rn(var, eps));
    }
  }
  const bool has_res = res != nullptr;
  for (int64_t r = q.r0 + q.rl; r < q.r1; r += kUnrollBwd * (int64_t)q.rp) {
    float v[kUnrollBwd][V], w[kUnrollBwd][V] = {}, d[kUnrollBwd][V];
    bool ok[kUnrollBwd];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int64_t row = q.base + r + u * (int64_t)q.rp;
      ok[u] = r + u * (int64_t)q.rp < q.r1 && __ldg(keys + row) != kSentinel;
      if (ok[u]) {
        load_vec<T, V>(x + row * c + q.lane * V, v[u]);
        load_vec<T, V>(dy + row * c + q.lane * V, d[u]);
        if (has_res) load_vec<T, V>(res + row * c + q.lane * V, w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      if (r + u * (int64_t)q.rp >= q.r1) continue;
      const int64_t row = q.base + r + u * (int64_t)q.rp;
      float gx[V], gr[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        gx[e] = gr[e] = 0.f;
        if (!ok[u]) continue;
        gr[e] = act_grad<T>(
            pre_act<T, INST>(v[u][e], mean[e], a[e], b[e], sh[e], has_res,
                             w[u][e]),
            d[u][e], act);
        const float xc = __fsub_rn(v[u][e], mean[e]);
        const float inv = INST ? __fdiv_rn(b[e], a[e]) : a[e];
        gx[e] = inv * (gr[e] - s1[e] - xc * s2[e]);
      }
      store_vec<T, V>(dx + row * c + q.lane * V, gx);
      if (dres != nullptr) store_vec<T, V>(dres + row * c + q.lane * V, gr);
    }
  }
}

// ---- launches --------------------------------------------------------------

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The arguments every entry checks: dtype 0 (float32) or 1 (bfloat16);
// `vec` channels a thread, 16 bytes' worth or 1, dividing C; `threads` a
// whole number of rows of C / vec threads, at most kMaxThreads; `blocks`
// CTAs of `rows_per_cta` rows covering a group's `rows` with none empty;
// the tensors read or written by vector 16-byte aligned.
bool geometry_ok(int64_t groups, int64_t rows, int64_t channels,
                 int64_t rows_per_cta, int64_t blocks, int dtype, int vec,
                 int threads, std::initializer_list<const void*> vectors) {
  const int elt = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || channels <= 0 || groups <= 0 ||
      groups > 65535 || rows <= 0 || rows_per_cta <= 0 || blocks <= 0 ||
      blocks * groups > INT32_MAX || (vec != 1 && vec * elt != 16) ||
      channels % vec != 0 || threads <= 0 || threads > kMaxThreads ||
      threads % (channels / vec) != 0 || blocks * rows_per_cta < rows ||
      (blocks - 1) * rows_per_cta >= rows)
    return false;
  if (vec > 1)
    for (const void* p : vectors)
      if (!aligned(p)) return false;
  return true;
}

// Shared memory of the reducing kernels: NA accumulators of V floats a
// thread, and at least 4 floats a thread for the final sums' ranges.
size_t reduce_smem(int na, int vec, int threads) {
  return (size_t)(na * vec > 4 ? na * vec : 4) * threads * sizeof(float);
}

#define NORM_DISPATCH(LAUNCH) \
  do {                        \
    if (dtype == 0 && vec == 4) { \
      LAUNCH(float, 4);       \
    } else if (dtype == 0) {  \
      LAUNCH(float, 1);       \
    } else if (vec == 8) {    \
      LAUNCH(__nv_bfloat16, 8); \
    } else {                  \
      LAUNCH(__nv_bfloat16, 1); \
    }                         \
  } while (0)

}  // namespace

// x [groups * rows, C] (dtype 0 float32, 1 bfloat16), keys [groups * rows]
// int64 (SENTINEL: padding); part [groups * blocks, C] f32 scratch;
// tickets 1 + groups ints, 0 before and after. Writes sums [groups, 1 + C]:
// each group's count of valid rows and their sum. Every entry returns the
// cudaError_t of its launch, or cudaErrorInvalidValue for arguments it
// does not take.
extern "C" int fcaf3d_masked_norm_stats(const void* x, const int64_t* keys,
                                        float* part, float* sums,
                                        int* tickets, int64_t groups,
                                        int64_t rows, int64_t channels,
                                        int64_t rows_per_cta, int64_t blocks,
                                        int dtype, int vec, int threads,
                                        void* stream) {
  if (!geometry_ok(groups, rows, channels, rows_per_cta, blocks, dtype, vec,
                   threads, {x}))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  const size_t smem = reduce_smem(1, vec, threads);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, V)                                                     \
  norm_stats_kernel<T, V><<<grid, threads, smem, s>>>(                   \
      (const T*)x, keys, part, sums, tickets, rows, (int)channels,       \
      rows_per_cta)
  NORM_DISPATCH(LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// As `fcaf3d_masked_norm_stats`, from its `sums` (after any all-reduce):
// writes sq [groups, C], the sum of the squared deviations about each
// group's mean.
extern "C" int fcaf3d_masked_norm_dev(const void* x, const int64_t* keys,
                                      const float* sums, float* part,
                                      float* sq, int* tickets, int64_t groups,
                                      int64_t rows, int64_t channels,
                                      int64_t rows_per_cta, int64_t blocks,
                                      int dtype, int vec, int threads,
                                      void* stream) {
  if (!geometry_ok(groups, rows, channels, rows_per_cta, blocks, dtype, vec,
                   threads, {x}))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  const size_t smem = reduce_smem(1, vec, threads);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, V)                                                    \
  norm_dev_kernel<T, V><<<grid, threads, smem, s>>>(                    \
      (const T*)x, keys, sums, part, sq, tickets, rows, (int)channels,  \
      rows_per_cta)
  NORM_DISPATCH(LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// out [groups * rows, C] in x's dtype: the norm with statistics (stat_a,
// stat_b) = (sums, sq) in `mode` 1 (BatchNorm) or 2 (InstanceNorm), the
// running (mean, var) [C] in mode 0; res (or null) added; act 0 none, 1
// ReLU, 2 ELU; invalid rows 0. run_mean / run_var (or null): moved to keep
// * running + m * batch.
extern "C" int fcaf3d_masked_norm_apply(
    const void* x, const int64_t* keys, const void* res, const float* stat_a,
    const float* stat_b, int mode, const float* scale,
    const float* shift, float* run_mean, float* run_var, float keep, float m,
    void* out, int64_t groups, int64_t rows, int64_t channels,
    int64_t rows_per_cta, int64_t blocks, int act, float eps, int dtype,
    int vec, int threads, void* stream) {
  if (!geometry_ok(groups, rows, channels, rows_per_cta, blocks, dtype, vec,
                   threads, {x, res, out}) ||
      act < kNone || act > kElu || mode < kRunning || mode > kInstance ||
      (run_mean == nullptr) != (run_var == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, V)                                                        \
  if (mode == kInstance)                                                    \
    norm_apply_kernel<T, V, true><<<grid, threads, 0, s>>>(                 \
        (const T*)x, keys, (const T*)res, stat_a, stat_b, mode, scale,      \
        shift, run_mean, run_var, keep, m, (T*)out, rows, (int)channels,    \
        rows_per_cta, act, eps);                                            \
  else                                                                      \
    norm_apply_kernel<T, V, false><<<grid, threads, 0, s>>>(                \
        (const T*)x, keys, (const T*)res, stat_a, stat_b, mode, scale,      \
        shift, run_mean, run_var, keep, m, (T*)out, rows, (int)channels,    \
        rows_per_cta, act, eps)
  NORM_DISPATCH(LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// The backward's sums: dy [groups * rows, C] in x's dtype and the
// forward's x, keys, res, statistics, scale and shift; part [groups *
// blocks, 2C] f32 scratch. Writes gsum [groups, 2C] (sum g, sum g (x -
// mean) of each group), dscale and dshift [C].
extern "C" int fcaf3d_masked_norm_bwd_reduce(
    const void* x, const int64_t* keys, const void* res, const void* dy,
    const float* stat_a, const float* stat_b, int mode,
    const float* scale, const float* shift, float* part, float* gsum,
    float* dscale, float* dshift, int* tickets, int64_t groups, int64_t rows,
    int64_t channels, int64_t rows_per_cta, int64_t blocks, int act,
    float eps, int dtype, int vec, int threads, void* stream) {
  if (!geometry_ok(groups, rows, channels, rows_per_cta, blocks, dtype, vec,
                   threads, {x, res, dy}) ||
      act < kNone || act > kElu || mode < kRunning || mode > kInstance)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  const size_t smem = reduce_smem(2, vec, threads);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, V)                                                      \
  if (mode == kInstance)                                                  \
    norm_bwd_reduce_kernel<T, V, true><<<grid, threads, smem, s>>>(       \
        (const T*)x, keys, (const T*)res, (const T*)dy, stat_a, stat_b,   \
        mode, scale, shift, part, gsum, dscale, dshift, tickets, rows,    \
        (int)channels, rows_per_cta, act, eps);                           \
  else                                                                    \
    norm_bwd_reduce_kernel<T, V, false><<<grid, threads, smem, s>>>(      \
        (const T*)x, keys, (const T*)res, (const T*)dy, stat_a, stat_b,   \
        mode, scale, shift, part, gsum, dscale, dshift, tickets, rows,    \
        (int)channels, rows_per_cta, act, eps)
  NORM_DISPATCH(LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// dx (and dres, or null) [groups * rows, C] in x's dtype, from gsum
// (after any all-reduce) and the forward's tensors.
extern "C" int fcaf3d_masked_norm_bwd_apply(
    const void* x, const int64_t* keys, const void* res, const void* dy,
    const float* stat_a, const float* stat_b, int mode,
    const float* scale, const float* shift, const float* gsum, void* dx,
    void* dres, int64_t groups, int64_t rows, int64_t channels,
    int64_t rows_per_cta, int64_t blocks, int act, float eps, int dtype,
    int vec, int threads, void* stream) {
  if (!geometry_ok(groups, rows, channels, rows_per_cta, blocks, dtype, vec,
                   threads, {x, res, dy, dx, dres}) ||
      act < kNone || act > kElu || mode < kRunning || mode > kInstance ||
      (dres != nullptr && res == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, V)                                                        \
  if (mode == kInstance)                                                    \
    norm_bwd_apply_kernel<T, V, true><<<grid, threads, 0, s>>>(             \
        (const T*)x, keys, (const T*)res, (const T*)dy, stat_a, stat_b,     \
        mode, scale, shift, gsum, (T*)dx, (T*)dres, rows, (int)channels,    \
        rows_per_cta, act, eps);                                            \
  else                                                                      \
    norm_bwd_apply_kernel<T, V, false><<<grid, threads, 0, s>>>(            \
        (const T*)x, keys, (const T*)res, (const T*)dy, stat_a, stat_b,     \
        mode, scale, shift, gsum, (T*)dx, (T*)dres, rows, (int)channels,    \
        rows_per_cta, act, eps)
  NORM_DISPATCH(LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
