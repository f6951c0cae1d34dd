// K8: the optimizer step of every train state of the port, the global-norm
// gradient clip and AdamW over every leaf of the model, in two launches.
//
// Replaces no TPU kernel: the JAX package's optax chain
// (clip_by_global_norm, adamw) is jnp ops over the parameter pytree, which
// XLA fuses on the TPU. Eager PyTorch runs the same chain leaf by leaf
// (train/optim.py's plain loop): 22 launches a leaf, 3 280 a step at
// fcaf3d_scannet's 149 leaves, and the host's launch rate sets its time.
//
// What bounds it on the H100: memory traffic, 32 bytes a parameter (the
// norm reads g; the update reads p, g, mu and nu and writes p, mu and nu).
//
// - The work list: a device table of the leaves, kFields int64 a leaf:
//   the addresses of p, mu and nu, the leaf's length and its first chunk,
//   which the caller uploads only when one of those addresses changes;
//   and the gradients' addresses (0: no gradient, read as zeros), which
//   move from step to step, as a kernel parameter (Grads, kMaxLeaves
//   pointers in the classic 4 KB of parameters), so a step copies nothing
//   to the card. A leaf is cut into chunks of kChunk elements; CTA b of a
//   launch takes chunk b of the step, in the leaf whose first chunk is the
//   last at or below b (a binary search of the table).
// - clip_adamw_norm: each CTA sums g * g over its chunk in f32 (each
//   thread in a fixed order, then a fixed tree) into its slot; the last CTA
//   to finish (an integer ticket) adds the slots in slot order and writes
//   sqrt of the total, so the norm repeats bitwise.
// - clip_adamw_update: reads the norm, scales g by grad_clip / norm where
//   norm >= grad_clip, and applies optax's adamw in its order of
//   operations, each in f32 with round-to-nearest intrinsics (no FMA
//   contraction), IEEE division and square root; p, mu and nu in place.
//   The bias corrections divide as ATen's CUDA kernels divide a tensor by
//   a host scalar, by a multiply with the scalar's f32 reciprocal, so that
//   the step repeats the plain loop on the card bit for bit wherever the
//   norm stays below the clip (the norm's order of summation is the one
//   difference).
// - 16-byte vector loads and stores where a leaf's four addresses are
//   16-byte aligned (a chunk keeps the alignment: kChunk is a multiple of
//   4); scalar otherwise, and for the leaf's last numel % 4 elements.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFields = 5;  // p, mu, nu, numel, first chunk
constexpr int kMaxLeaves = 480;
constexpr int64_t kChunk = 16384;  // elements a CTA
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread loads before it uses any

// The hyperparameters, each rounded to f32 as the plain loop's scalars are;
// inv_c1, inv_c2: 1 / c1 and 1 / c2 divided in f32.
struct Hyper {
  float grad_clip, b1, omb1, b2, omb2, inv_c1, inv_c2, eps, wd, neg_lr;
};

// The gradients' addresses, by leaf: 3 840 bytes of kernel parameters.
struct Grads {
  const float* g[kMaxLeaves];
};

// This CTA's chunk: elements [begin, end) of one leaf.
struct Chunk {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  int64_t begin, end;
  bool vec;
};

__device__ Chunk find_chunk(const int64_t* __restrict__ table, int leaves,
                            const Grads& grads) {
  __shared__ int64_t row[kFields + 1];  // the table's row, then g
  if (threadIdx.x == 0) {
    int lo = 0, hi = leaves - 1;  // the last leaf whose first chunk <= b
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[(int64_t)mid * kFields + 4] <= (int64_t)blockIdx.x)
        lo = mid;
      else
        hi = mid - 1;
    }
    for (int f = 0; f < kFields; ++f) row[f] = table[(int64_t)lo * kFields + f];
    row[kFields] = reinterpret_cast<int64_t>(grads.g[lo]);
  }
  __syncthreads();
  Chunk c;
  c.p = reinterpret_cast<float*>(row[0]);
  c.mu = reinterpret_cast<float*>(row[1]);
  c.nu = reinterpret_cast<float*>(row[2]);
  c.g = reinterpret_cast<const float*>(row[kFields]);
  c.begin = ((int64_t)blockIdx.x - row[4]) * kChunk;
  c.end = min(row[3], c.begin + kChunk);
  c.vec = ((row[0] | row[1] | row[2] | row[kFields]) & 15) == 0;
  return c;
}

// The CTA's sum of v in a fixed order (a shuffle tree in each warp, then
// the warps' sums in warp 0); valid in thread 0.
__device__ float block_sum(float v, float* smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? smem[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  __syncthreads();
  return v;
}

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__global__ void __launch_bounds__(kThreads)
    clip_adamw_norm_kernel(const int64_t* __restrict__ table, int leaves,
                           const __grid_constant__ Grads grads,
                           float* __restrict__ slots, int* ticket,
                           float* __restrict__ norm) {
  __shared__ float smem[kThreads / 32];
  __shared__ bool is_last;
  const Chunk c = find_chunk(table, leaves, grads);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int64_t tail = c.begin;
  if (c.g != nullptr && c.vec) {
    const int64_t nv = (c.end - c.begin) / 4;
    const float4* g4 = reinterpret_cast<const float4*>(c.g + c.begin);
    for (int64_t v = threadIdx.x; v < nv; v += kThreads * kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t k = v + (int64_t)u * kThreads;
        x[u] = k < nv ? __ldg(g4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc[0] = __fadd_rn(acc[0], sq(x[u].x));
        acc[1] = __fadd_rn(acc[1], sq(x[u].y));
        acc[2] = __fadd_rn(acc[2], sq(x[u].z));
        acc[3] = __fadd_rn(acc[3], sq(x[u].w));
      }
    }
    tail = c.begin + nv * 4;
  }
  if (c.g != nullptr)
    for (int64_t k = tail + threadIdx.x; k < c.end; k += kThreads)
      acc[0] = __fadd_rn(acc[0], sq(__ldg(c.g + k)));
  float s = __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
  s = block_sum(s, smem);
  if (threadIdx.x == 0) {
    slots[blockIdx.x] = s;
    __threadfence();
    is_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float t = 0.f;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads)
    t = __fadd_rn(t, __ldcg(slots + k));
  t = block_sum(t, smem);
  if (threadIdx.x == 0) {
    *norm = __fsqrt_rn(t);
    *ticket = 0;
  }
}

// One element: the plain loop's
//   g = where(clip, g / norm * grad_clip, g)
//   mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * (g * g) + b2 * nu
//   u = (mu / c1) / (sqrt(nu / c2) + eps) + wd * p;  p = p + (-lr) * u
// with x / c as x * (1 / c) for the two bias corrections c.
__device__ __forceinline__ void adamw(float& p, float g, float& mu,
                                      float& nu, const Hyper& h, bool clip,
                                      float norm) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, norm), h.grad_clip);
  mu = __fadd_rn(__fmul_rn(h.omb1, g), __fmul_rn(h.b1, mu));
  nu = __fadd_rn(__fmul_rn(h.omb2, sq(g)), __fmul_rn(h.b2, nu));
  float u = __fdiv_rn(__fmul_rn(mu, h.inv_c1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(nu, h.inv_c2)), h.eps));
  u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(h.neg_lr, u));
}

__global__ void __launch_bounds__(kThreads)
    clip_adamw_update_kernel(const int64_t* __restrict__ table, int leaves,
                             const __grid_constant__ Grads grads,
                             const float* __restrict__ norm_in, Hyper h) {
  const Chunk c = find_chunk(table, leaves, grads);
  const float norm = __ldg(norm_in);
  const bool clip = norm >= h.grad_clip;
  int64_t tail = c.begin;
  if (c.vec) {
    const int64_t nv = (c.end - c.begin) / 4;
    float4* p4 = reinterpret_cast<float4*>(c.p + c.begin);
    const float4* g4 = reinterpret_cast<const float4*>(c.g + c.begin);
    float4* m4 = reinterpret_cast<float4*>(c.mu + c.begin);
    float4* n4 = reinterpret_cast<float4*>(c.nu + c.begin);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t v = threadIdx.x; v < nv; v += kThreads * kUnroll) {
      float4 p[kUnroll], g[kUnroll], m[kUnroll], n[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t k = v + (int64_t)u * kThreads;
        if (k < nv) {
          p[u] = p4[k];
          g[u] = c.g != nullptr ? __ldg(g4 + k) : zero;
          m[u] = m4[k];
          n[u] = n4[k];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t k = v + (int64_t)u * kThreads;
        if (k < nv) {
          adamw(p[u].x, g[u].x, m[u].x, n[u].x, h, clip, norm);
          adamw(p[u].y, g[u].y, m[u].y, n[u].y, h, clip, norm);
          adamw(p[u].z, g[u].z, m[u].z, n[u].z, h, clip, norm);
          adamw(p[u].w, g[u].w, m[u].w, n[u].w, h, clip, norm);
          p4[k] = p[u];
          m4[k] = m[u];
          n4[k] = n[u];
        }
      }
    }
    tail = c.begin + nv * 4;
  }
  for (int64_t k = tail + threadIdx.x; k < c.end; k += kThreads) {
    float p = c.p[k], mu = c.mu[k], nu = c.nu[k];
    adamw(p, c.g != nullptr ? __ldg(c.g + k) : 0.f, mu, nu, h, clip, norm);
    c.p[k] = p;
    c.mu[k] = mu;
    c.nu[k] = nu;
  }
}

bool work_ok(const void* table, int64_t leaves, int64_t chunks,
             const int64_t* grads) {
  return table != nullptr && grads != nullptr && leaves > 0 &&
         leaves <= kMaxLeaves && chunks >= leaves && chunks <= INT32_MAX;
}

Grads grads_of(const int64_t* grads, int64_t leaves) {
  Grads out{};
  for (int64_t i = 0; i < leaves; ++i)
    out.g[i] = reinterpret_cast<const float*>(grads[i]);
  return out;
}

}  // namespace

// The global norm: `table` [leaves, kFields] int64 on the card, every
// leaf's length > 0, its chunks `chunks` in all; `grads` the gradients'
// addresses on the host (0: none), read before the call returns; slots
// [chunks] f32 scratch; ticket one int, 0 before and after; writes norm
// (one f32).
extern "C" int fcaf3d_clip_adamw_norm(const int64_t* table, int64_t leaves,
                                      int64_t chunks, const int64_t* grads,
                                      float* slots, int* ticket, float* norm,
                                      void* stream) {
  if (!work_ok(table, leaves, chunks, grads) || slots == nullptr ||
      ticket == nullptr || norm == nullptr)
    return (int)cudaErrorInvalidValue;
  clip_adamw_norm_kernel<<<(unsigned)chunks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      table, (int)leaves, grads_of(grads, leaves), slots, ticket, norm);
  return (int)cudaGetLastError();
}

// The clip and AdamW step in place, from the norm the first launch wrote.
extern "C" int fcaf3d_clip_adamw_update(
    const int64_t* table, int64_t leaves, int64_t chunks,
    const int64_t* grads, const float* norm, float grad_clip, float b1,
    float omb1, float b2, float omb2, float inv_c1, float inv_c2, float eps,
    float wd, float neg_lr, void* stream) {
  if (!work_ok(table, leaves, chunks, grads) || norm == nullptr)
    return (int)cudaErrorInvalidValue;
  const Hyper h{grad_clip, b1, omb1, b2, omb2, inv_c1, inv_c2, eps, wd,
                neg_lr};
  clip_adamw_update_kernel<<<(unsigned)chunks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      table, (int)leaves, grads_of(grads, leaves), norm, h);
  return (int)cudaGetLastError();
}
