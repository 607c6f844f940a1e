// Target device functions inlined into the fused kernels.
//
// Replace mcmc_tpu/ops/padded_targets.py:_standard_normal and _neals_funnel.
// A group of G lanes (G a power of two, 32 = a whole warp) holds one chain:
// each lane owns K coordinates (zeros past dim), and coordinate 0 is register
// 0 of the group's lane 0. The GRAHMC and NUTS kernels use G = 32 with lane j
// owning j, j+32, ...; the RWMH kernel packs 32 / G chains into a warp, lane
// j of a group owning 4j..4j+3. Each functor maps this lane's q to its
// gradient entries and returns the chain's log-density, identical on every
// lane of the group. The float arithmetic follows the plain PyTorch version
// in mcmc_tpu_torch/ops/padded_targets.py term for term.
#pragma once

#include <cuda_runtime.h>

namespace mcmc {

// Must match FAMILY_IDS in mcmc_tpu_torch/ops/padded_targets.py.
enum Family { STANDARD_NORMAL = 0, NEALS_FUNNEL = 1 };

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr double LOG_2PI = 1.8378770664093453;         // log(2 pi)
constexpr double LOG_2PI_9 = 4.0351016437455645;       // log(2 pi * 9)

// Sum over each aligned group of G lanes; every lane gets its group's
// total. All 32 lanes of the warp must take part.
template <int G = 32>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(FULL_MASK, v, offset);
  }
  return v;
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) { return group_sum<32>(v); }

template <int FAMILY, int K, int G = 32>
struct Target;

// N(0, I): lp = -0.5 (sum q^2 + D log 2pi), grad = -q.
template <int K, int G>
struct Target<STANDARD_NORMAL, K, G> {
  float c;
  __device__ explicit Target(int dim) : c(static_cast<float>(dim * LOG_2PI)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int /*lane*/) const {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      s += q[r] * q[r];
      g[r] = -q[r];
    }
    return -0.5f * (group_sum<G>(s) + c);
  }
};

// Neal's funnel: x0 ~ N(0, 9), x_i | x0 ~ N(0, exp(x0)). The neck x0 is
// coordinate 0, the group's lane 0's first register; it is broadcast with
// one shuffle. `lane` is the lane's index within its group.
template <int K, int G>
struct Target<NEALS_FUNNEL, K, G> {
  float d_rest, c_rest, c_neck;
  __device__ explicit Target(int dim)
      : d_rest(static_cast<float>(dim - 1)),
        c_rest(static_cast<float>((dim - 1) * LOG_2PI)),
        c_neck(static_cast<float>(LOG_2PI_9)) {}

  __device__ __forceinline__ float operator()(const float (&q)[K], float (&g)[K],
                                              int lane) const {
    const float x0 = __shfl_sync(FULL_MASK, q[0], 0, G);
    const float inv_var = expf(-x0);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float v = (r == 0 && lane == 0) ? 0.f : q[r];
      s += v * v;
      g[r] = -q[r] * inv_var;
    }
    const float sum_sq = group_sum<G>(s);
    if (lane == 0) {
      g[0] = -x0 / 9.f + 0.5f * inv_var * sum_sq - 0.5f * d_rest;
    }
    return -0.5f * (x0 * x0 / 9.f + c_neck) -
           0.5f * (sum_sq * inv_var + d_rest * x0 + c_rest);
  }
};

}  // namespace mcmc
