// Philox4x32-10 counter-based generator (Salmon, Moraes, Dror, Shaw,
// "Parallel random numbers: as easy as 1, 2, 3", SC11), written out for the
// fused kernels. Bit-identical to philox4x32_10 in
// mcmc_tpu_torch/ops/fused_trajectory.py, which the plain versions use.
//
// Counter layout shared by every kernel: (chain, call, t, draw), `call` a
// host counter per kernel call and `t` the transition (GRAHMC, RWMH) or
// machine iteration (NUTS) inside the call. Standard-normal coordinate d is
// Box-Muller on draw d / 4 (words (x0, x1) for d % 4 in {0, 1} -- cos, sin --
// and (x2, x3) for {2, 3}); draws 32 and up are scalar per chain
// (philox_normal, philox_uniform and the NUTS draws in PyTorch).
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

constexpr uint32_t ACCEPT_DRAW = 32;  // the per-chain uniform of draw 32, word x0
constexpr float TWO_PI_F = 6.283185307179586f;

// p ~ N(0, M) for this lane's coordinates lane + 32 r of a warp-per-chain
// layout; zeros past dim.
template <int K>
__device__ __forceinline__ void philox_momentum(float (&p)[K], const float (&invm)[K],
                                                int lane, int dim, uint32_t chain,
                                                uint32_t call, uint32_t t, uint32_t k0,
                                                uint32_t k1) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int d = lane + 32 * r;
    p[r] = 0.f;
    if (d < dim) {
      const uint4 x = philox4x32_10(make_uint4(chain, call, t, static_cast<uint32_t>(d >> 2)),
                                    k0, k1);
      const bool second_pair = (d & 2) != 0;
      const float ua = bits_to_uniform(second_pair ? x.z : x.x);
      const float ub = bits_to_uniform(second_pair ? x.w : x.y);
      const float rad = sqrtf(-2.f * logf(ua));
      const float theta = TWO_PI_F * ub;
      const float z = (d & 1) ? rad * sinf(theta) : rad * cosf(theta);
      p[r] = z / sqrtf(invm[r]);
    }
  }
}

__device__ __forceinline__ float philox_accept_uniform(uint32_t chain, uint32_t call,
                                                       uint32_t t, uint32_t k0,
                                                       uint32_t k1) {
  return bits_to_uniform(philox4x32_10(make_uint4(chain, call, t, ACCEPT_DRAW), k0, k1).x);
}

}  // namespace mcmc
