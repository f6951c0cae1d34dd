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
// over N points plus a block-wide argmax. At N = 20000, S = 2048 the work is
// ~40 M distance updates, tiny for the card; the time is S x (one pass over
// the cloud from L1/L2 + two block barriers), latency rather than bandwidth.
//
// Design: one CTA of 1024 threads per cloud. The running minima stay in
// shared memory (N floats, 80 KB at N = 20000; a global scratch row when N
// is too large for it). Each thread owns points i = tid + k * 1024, so it
// reads and writes only its own minima and needs no barrier for them. The
// argmax is a (value, index) reduction through warp shuffles, then across
// the 32 warps through shared memory; the chosen index is broadcast through
// shared memory. One CTA per cloud leaves the other SMs idle at batch 1:
// a multi-CTA (cluster) version is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
      const float dx = __fsub_rn(__ldg(p + 3 * i), lx);
      const float dy = __fsub_rn(__ldg(p + 3 * i + 1), ly);
      const float dz = __fsub_rn(__ldg(p + 3 * i + 2), lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
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
