// Philox4x32-10 counter-based generator (Salmon, Moraes, Dror, Shaw,
// "Parallel random numbers: as easy as 1, 2, 3", SC11), written out for the
// fused GRAHMC kernels. Bit-identical to philox4x32_10 in
// mcmc_tpu_torch/ops/fused_trajectory.py, which the plain versions use.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mcmc {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// uint32 bits -> float uniform in (0, 1]: (bits >> 8) * 2^-24 + 2^-25,
// a 24-bit mantissa that is never 0 (log(u) stays finite).
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f +
         2.98023223876953125e-08f;
}

}  // namespace mcmc
