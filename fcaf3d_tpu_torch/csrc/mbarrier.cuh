// mbarriers in PTX, shared by the kernels that complete asynchronous copies
// or stores on one: K5 (`fps.cu`, st.async across a thread-block cluster)
// and K6 (`ball_query.cu`, cp.async.bulk tiles). Addresses are shared-memory
// addresses of the calling CTA.
#pragma once

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies or stores
// on the current phase
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;" ::
          "r"(bar),
      "r"(bytes)
      : "memory");
}

// returns once the phase of `parity` has completed (acquire, cluster scope)
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
