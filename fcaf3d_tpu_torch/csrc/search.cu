// K1: per-sample sorted-key search (searchsorted, side='left'), optionally
// hit-verified.
//
// Replaces the TPU kernel fcaf3d_tpu/ops/sparse/search.py::_searchsorted_pallas
// (entry searchsorted_segments), which counts `key < query` over a key array
// held in VMEM, a chunk of queries at a time.
//
// What bounds it on the H100: one call looks up at most ~1.2M queries (a
// 27-offset kernel map over ~43k output rows) in at most ~45k int64 keys per
// sample (360 KB, resident in the 50 MB L2 after the first touches). Each
// query takes ~16 dependent loads, so the kernel is bound by load latency out
// of L2, not by bandwidth or arithmetic.
//
// Design: one thread per query runs a lower-bound binary search over its
// sample's keys and tests equality at the end of the same pass. The latency
// is hidden only by the number of warps in flight; nothing is staged in
// shared memory. Keys are int64 carrying uint32 values with the padding value
// 0xFFFFFFFF, so the padding sorts last and never equals a real query.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kSentinel = 0xFFFFFFFFLL;
constexpr int kThreads = 256;

__global__ void searchsorted_kernel(const int64_t* __restrict__ keys,
                                    const int64_t* __restrict__ queries,
                                    int32_t* __restrict__ out,
                                    int64_t n_keys, int64_t n_queries,
                                    int64_t total, int with_miss) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t* k = keys + (i / n_queries) * n_keys;
  const int64_t q = queries[i];
  int64_t lo = 0, hi = n_keys;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (k[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (with_miss) {
    const bool hit = lo < n_keys && k[lo] == q && q != kSentinel;
    out[i] = (int32_t)(hit ? lo : n_keys);
  } else {
    out[i] = (int32_t)lo;
  }
}

}  // namespace

// keys [B, N] ascending per sample; queries [B, Q]; out [B, Q] int32 in
// [0, N]. With with_miss, a query that is absent or is the padding value
// returns N. Returns the cudaError_t of the launch.
extern "C" int fcaf3d_searchsorted(const int64_t* keys, const int64_t* queries,
                                   int32_t* out, int64_t batch, int64_t n_keys,
                                   int64_t n_queries, int with_miss,
                                   void* stream) {
  const int64_t total = batch * n_queries;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  searchsorted_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(keys, queries, out, n_keys,
                                                n_queries, total, with_miss);
  return (int)cudaGetLastError();
}
