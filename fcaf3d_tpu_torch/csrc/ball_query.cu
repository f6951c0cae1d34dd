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
// 64 samples) most centres scan the whole cloud (few points lie within
// 0.2 m), so the work is up to M x N distance tests, 41 M at SA1: a few
// hundred MB of L2 reads, bound by L2 bandwidth and latency, not by math.
//
// Design: one warp per centre, 8 warps per block. The warp reads 32 points
// at a time (neighbouring lanes, neighbouring points); __ballot_sync marks
// the hits and __popc of the lower lanes' bits gives each hit its slot, so
// the hits land in index order with no sort. The warp stops as soon as it
// holds nsample hits. There is no candidate cap: nothing can overflow.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ball_query_kernel(const float* __restrict__ centers,
                      const float* __restrict__ points,
                      const uint8_t* __restrict__ valid,
                      int32_t* __restrict__ out, int64_t rows, int m, int n,
                      int nsample, float r2) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int64_t b = row / m;
  const float cx = __ldg(centers + 3 * row);
  const float cy = __ldg(centers + 3 * row + 1);
  const float cz = __ldg(centers + 3 * row + 2);
  const float* p = points + b * n * 3;
  const uint8_t* v = valid == nullptr ? nullptr : valid + b * n;
  int32_t* o = out + row * nsample;
  const unsigned lower = (1u << lane) - 1u;

  int count = 0;  // hits so far, the same in every lane
  int first = 0;  // the first hit; 0 while there is none
  for (int base = 0; base < n && count < nsample; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < n && (v == nullptr || v[i])) {
      const float dx = __fsub_rn(__ldg(p + 3 * i), cx);
      const float dy = __fsub_rn(__ldg(p + 3 * i + 1), cy);
      const float dz = __fsub_rn(__ldg(p + 3 * i + 2), cz);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (count == 0 && ballot != 0u) first = base + __ffs(ballot) - 1;
    const int slot = count + __popc(ballot & lower);
    if (hit && slot < nsample) o[slot] = i;
    count += __popc(ballot);
  }
  for (int k = min(count, nsample) + lane; k < nsample; k += 32) o[k] = first;
}

}  // namespace

// centers [B, M, 3], points [B, N, 3] f32 contiguous; valid [B, N] bytes or
// null; out [B, M, nsample] int32; r2 the squared radius in f32. Returns
// the cudaError_t of the launch.
extern "C" int fcaf3d_ball_query(const float* centers, const float* points,
                                 const uint8_t* valid, int32_t* out,
                                 int64_t batch, int64_t m, int64_t n,
                                 int64_t nsample, float r2, void* stream) {
  const int64_t rows = batch * m;
  if (rows == 0 || nsample == 0) return 0;
  if (n <= 0 || n > INT32_MAX / 3 || m > INT32_MAX || nsample > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ball_query_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                      (cudaStream_t)stream>>>(centers, points, valid, out,
                                              rows, (int)m, (int)n,
                                              (int)nsample, r2);
  return (int)cudaGetLastError();
}
