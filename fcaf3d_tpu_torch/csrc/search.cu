// K1: per-sample sorted-key search (searchsorted, side='left'), optionally
// hit-verified.
//
// Replaces the TPU kernel fcaf3d_tpu/ops/sparse/search.py::_searchsorted_pallas
// (entry searchsorted_segments), which counts `key < query` over a key array
// held in VMEM, a chunk of queries at a time, and narrows each chunk's key
// range first because the queries arrive in nearly sorted segments.
//
// What bounds it on the H100: one call looks up at most ~1.2M queries (a
// 27-offset kernel map over ~43k output rows) in at most ~100k int64 keys
// per sample (resident in the 50 MB L2 after the first touches). The bytes
// (keys, queries and positions, each once) take a few microseconds at the
// memory rate; what a kernel has to beat is the latency of dependent loads.
//
// Keys are int64 carrying uint32 values with the padding value 0xFFFFFFFF,
// so the padding sorts last and never equals a real query. Queries come as
// [B, M, S]: S segments (a kernel map's offsets), each ascending in m but
// for its padding; the kernel is exact for any order.
//
// Design (`searchsorted_gallop`): one thread walks one segment over a run
// of consecutive rows, starting from its previous answer: it doubles its
// step from there until it passes the query (forward, or backward for a
// smaller query), then binary-searches the bracket. A kernel map's next row
// is a key or two on, so a query costs two or three dependent loads of one
// cache line, instead of the ~16 of a binary search over all keys.
// Consecutive threads take consecutive segments of one run, so the warp's
// query loads are contiguous. At one row a thread it skips the run
// arithmetic and is a plain binary search.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kSentinel = 0xFFFFFFFFLL;
constexpr int kThreads = 256;

// Hit-verified or plain result of lower bound `pos` of q in kb[0, n).
__device__ __forceinline__ int32_t result(const int64_t* kb, int64_t n,
                                          int64_t pos, int64_t q,
                                          int with_miss) {
  if (!with_miss) return (int32_t)pos;
  const bool hit = pos < n && __ldg(kb + pos) == q && q != kSentinel;
  return (int32_t)(hit ? pos : n);
}

// First index in [lo, hi) whose key is >= q, given that it lies in [lo, hi].
__device__ __forceinline__ int lower_bound(const int64_t* kb, int lo, int hi,
                                           int64_t q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(kb + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// lane = ((b * runs) + run) * S + s: rows [run * per_run, ...) of segment s.
// Lanes and rows are below 2^31, keys a sample below 2^30 (checked by the
// entry).
__global__ void __launch_bounds__(kThreads)
    searchsorted_gallop_kernel(const int64_t* __restrict__ keys,
                               const int64_t* __restrict__ queries,
                               int32_t* __restrict__ out, int n_keys,
                               int m_rows, int n_segs, int runs, int per_run,
                               int lanes, int with_miss) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  if (per_run == 1) {  // the lane is the query: one search over all keys
    const int64_t* kb = keys + (int64_t)(lane / (m_rows * n_segs)) * n_keys;
    const int64_t q = __ldg(queries + lane);
    out[lane] = result(kb, n_keys, lower_bound(kb, 0, n_keys, q), q,
                       with_miss);
    return;
  }
  const int s = lane % n_segs, rest = lane / n_segs;
  const int run = rest % runs, b = rest / runs;
  const int64_t* kb = keys + (int64_t)b * n_keys;
  const int64_t base = (int64_t)b * m_rows * n_segs + s;
  const int m_end = min((run + 1) * per_run, m_rows);
  int pos = -1;
  int64_t prev = 0;
  for (int m = run * per_run; m < m_end; ++m) {
    const int64_t i = base + (int64_t)m * n_segs;
    const int64_t q = __ldg(queries + i);
    int lo, hi;
    if (pos < 0) {
      lo = 0;
      hi = n_keys;
    } else if (q >= prev) {  // every key before pos is < prev <= q
      lo = pos;
      hi = pos;
      for (int step = 1; hi < n_keys && __ldg(kb + hi) < q; step <<= 1) {
        lo = hi + 1;
        hi = lo + step;
      }
      hi = min(hi, n_keys);  // keys before lo are < q; key hi (if any) >= q
    } else {  // every key from pos on is >= prev > q
      lo = pos;
      hi = pos;
      for (int step = 1; lo > 0 && __ldg(kb + lo - 1) >= q; step <<= 1) {
        hi = lo - 1;
        lo = max(hi - step, 0);
      }  // keys from hi on are >= q; key lo - 1 (if any) < q
    }
    pos = lower_bound(kb, lo, hi, q);
    prev = q;
    out[i] = result(kb, n_keys, pos, q, with_miss);
  }
}

}  // namespace

// keys [B, N] ascending per sample; queries [B, M, S]; out [B, M, S] int32
// in [0, N]. With with_miss, a query that is absent or is the padding value
// returns N. `per_run` consecutive rows of one segment a thread, kThreads
// threads a CTA. Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for shapes beyond the kernel's int32 indexing.
extern "C" int fcaf3d_searchsorted_gallop(const int64_t* keys,
                                          const int64_t* queries, int32_t* out,
                                          int64_t batch, int64_t n_keys,
                                          int64_t m_rows, int64_t n_segs,
                                          int64_t per_run, int with_miss,
                                          void* stream) {
  if (batch * m_rows * n_segs == 0) return 0;
  const int64_t runs = per_run > 0 ? (m_rows + per_run - 1) / per_run : 0;
  const int64_t lanes = batch * runs * n_segs;
  constexpr int64_t kMax = ((int64_t)1 << 31) - kThreads;
  // n_keys below 2^30: the forward gallop's bracket end stays below 2^31
  if (per_run <= 0 || n_keys > kMax / 2 || m_rows > kMax || lanes > kMax)
    return (int)cudaErrorInvalidValue;
  searchsorted_gallop_kernel<<<(unsigned)((lanes + kThreads - 1) / kThreads),
                               kThreads, 0, (cudaStream_t)stream>>>(
      keys, queries, out, (int)n_keys, (int)m_rows, (int)n_segs, (int)runs,
      (int)per_run, (int)lanes, with_miss);
  return (int)cudaGetLastError();
}
