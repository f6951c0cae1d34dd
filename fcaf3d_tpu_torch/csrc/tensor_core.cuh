// Device helpers of the tensor-core kernels (K2 `gather_gemm_tc.cu`, K4
// `gather_dw_tc.cu`): 16-byte `cp.async` row gathers into shared memory,
// `ldmatrix` fragment loads and the bf16 `mma.sync` m16n8k16 product with
// float32 accumulators.
//
// Fragment layouts are those of the PTX ISA for mma.m16n8k16 (.bf16): lane l
// holds A rows l/4 and l/4 + 8, B column l/4 and C rows l/4 and l/4 + 8, at
// k (or n) pairs 2 (l % 4), 2 (l % 4) + 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

// Row stride, in elements, of a bf16 tile of `cols` columns in shared
// memory: an odd number of 16-byte units, so that the eight row addresses of
// one ldmatrix phase fall on eight different groups of four banks.
__host__ __device__ constexpr int smem_stride(int cols) {
  return (cols / 8) % 2 == 1 ? cols : cols + 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously. When `valid` is
// false nothing is read (source size 0) and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k16 step of a warp's MT x NT grid of m16n8 tiles: acc[mt][nt] +=
// A[m0 + 16 mt .., k0 ..] * B[k0 .., n0 + 8 nt ..].
//
// A lies in shared memory as [m][k] (A_TRANS false) or as [k][m] (A_TRANS
// true, loaded with ldmatrix.trans), with row stride `as`; B as [k][n] with
// row stride `bs`, loaded with ldmatrix.trans. Strides and offsets are in
// elements; every row address is 16-byte aligned.
template <int MT, int NT, bool A_TRANS>
__device__ __forceinline__ void warp_mma_k16(float (&acc)[MT][NT][4],
                                             const bf16* a, int as,
                                             const bf16* b, int bs, int m0,
                                             int n0, int k0, int lane) {
  const int i = lane % 8, g = lane / 8;  // row within a matrix, matrix
  uint32_t af[MT][4];
  uint32_t bfr[NT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if constexpr (A_TRANS) {
      // matrices: (k 0-7, m 0-7) (k 0-7, m 8-15) (k 8-15, m 0-7) (k 8-15,
      // m 8-15), each transposed into the row-major A fragment
      ldmatrix_x4_trans(af[mt], a + (k0 + i + (g / 2) * 8) * as + m0 +
                                    mt * 16 + (g % 2) * 8);
    } else {
      // lanes 0-15 address rows 0-15 at k 0-7, lanes 16-31 at k 8-15
      ldmatrix_x4(af[mt],
                  a + (m0 + mt * 16 + lane % 16) * as + k0 + (lane / 16) * 8);
    }
  }
  if constexpr (NT % 2 == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      // matrices: (k 0-7, tile nt) (k 8-15, nt) (k 0-7, nt + 1) (k 8-15,
      // nt + 1)
      uint32_t r[4];
      ldmatrix_x4_trans(r, b + (k0 + i + (g % 2) * 8) * bs + n0 +
                               (nt + g / 2) * 8);
      bfr[nt][0] = r[0];
      bfr[nt][1] = r[1];
      bfr[nt + 1][0] = r[2];
      bfr[nt + 1][1] = r[3];
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // lanes 0-15 give the addresses; 16-31 repeat them
      ldmatrix_x2_trans(bfr[nt],
                        b + (k0 + i + (g % 2) * 8) * bs + n0 + nt * 8);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], af[mt], bfr[nt]);
}

// Grants a kernel more than the default 48 KB of dynamic shared memory
// (once per kernel and size). Returns a cudaError_t.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= 48 * 1024 || bytes <= granted) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0) granted = bytes;
  return err;
}

}  // namespace tc
